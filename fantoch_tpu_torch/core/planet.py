"""Planet: inter-region latency model used by the simulator and planner.

Reference: fantoch/src/planet/{mod,region,dat}.rs.  Latencies come from real
GCP (20 regions) / AWS (19 regions) ping measurements; we ship them
pre-parsed as ``fantoch_tpu_torch/data/latency.json`` (a copy of the JAX
package's) (floor of the avg ping,
intra-region latency 0 — matching fantoch/src/planet/dat.rs:33-75 and
``INTRA_REGION_LATENCY`` in fantoch/src/planet/mod.rs:19).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

INTRA_REGION_LATENCY = 0

_DATA_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "latency.json")


@dataclass(frozen=True, order=True)
class Region:
    """A named region (fantoch/src/planet/region.rs)."""

    name: str

    def __str__(self) -> str:
        return self.name


class Planet:
    """Latency oracle over a set of regions (fantoch/src/planet/mod.rs:21-140)."""

    def __init__(self, latencies: Dict[Region, Dict[Region, int]]):
        self._latencies = latencies
        # regions sorted by (distance, region) per source, matching the
        # reference's sort_unstable over (latency, region) tuples
        self._sorted: Dict[Region, List[Tuple[int, Region]]] = {
            src: sorted((lat, dst) for dst, lat in entries.items())
            for src, entries in latencies.items()
        }

    # --- constructors ---

    @staticmethod
    def new(dataset: str = "gcp") -> "Planet":
        """Load the GCP (default) or AWS ping dataset."""
        with open(_DATA_PATH) as f:
            raw = json.load(f)[dataset]
        latencies = {
            Region(src): {Region(dst): lat for dst, lat in entries.items()}
            for src, entries in raw.items()
        }
        return Planet(latencies)

    @staticmethod
    def from_latencies(latencies: Dict[Region, Dict[Region, int]]) -> "Planet":
        return Planet(latencies)

    @staticmethod
    def equidistant(planet_distance: int, region_number: int) -> Tuple[List[Region], "Planet"]:
        """Synthetic planet where all distinct regions are `planet_distance`
        apart (fantoch/src/planet/mod.rs:57-100)."""
        regions = [Region(f"r_{i}") for i in range(region_number)]
        latencies = {
            a: {b: (INTRA_REGION_LATENCY if a == b else planet_distance) for b in regions}
            for a in regions
        }
        return regions, Planet(latencies)

    # --- queries ---

    def regions(self) -> List[Region]:
        return list(self._latencies.keys())

    def ping_latency(self, from_: Region, to: Region) -> Optional[int]:
        entries = self._latencies.get(from_)
        if entries is None:
            return None
        return entries.get(to)

    def sorted_by_distance(self, from_: Region) -> Optional[List[Tuple[int, Region]]]:
        """Regions sorted by distance (ascending) from `from_`."""
        return self._sorted.get(from_)

    def latency_matrix(self, regions: List[Region]) -> np.ndarray:
        """Dense int64 RTT matrix for a region subset — device-friendly form
        consumed by the planner (fantoch_tpu/planner) and sim sweeps."""
        m = np.zeros((len(regions), len(regions)), dtype=np.int64)
        for i, a in enumerate(regions):
            for j, b in enumerate(regions):
                lat = self.ping_latency(a, b)
                assert lat is not None, f"missing latency {a} -> {b}"
                m[i, j] = lat
        return m
