"""Concatenation of datasets, copied from monodepth2_tpu/data/dchain.py
(reference: src/dchain.jl DChain). Binary-search index mapping instead of the
reference's linear scan."""

from __future__ import annotations

import bisect
from typing import Optional, Sequence

import numpy as np


def resolves_item_K(dataset) -> bool:
    """Shared fail-fast capability probe for per_item_K training: True when
    every item of `dataset` can resolve an intrinsics matrix.

    Wrappers and chains (DChain, PerHostSampler) answer authoritatively via
    their own `supports_item_K`; plain datasets qualify by exposing either
    `K_of(i)` or a single constant `K`. DataLoader(with_K=True)
    and DChain route through this one function so the
    probe and the actual K resolution (`K_of`) cannot silently diverge."""
    s = getattr(dataset, "supports_item_K", None)
    if s is not None:
        return bool(s)
    return hasattr(dataset, "K_of") or hasattr(dataset, "K")


class DChain:
    """Concat dataset. Carries the FIRST child's intrinsics/frame layout so a
    chain can feed fit() directly — the reference likewise trains the whole
    chain with `dataset.datasets[1].K` (src/Monodepth.jl:99,110-115), even
    though per-sequence KITTI calibrations differ slightly."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("DChain needs at least one dataset")
        self.datasets = list(datasets)
        self.bins = np.cumsum([len(d) for d in self.datasets]).tolist()
        first = self.datasets[0]
        for attr in ("K", "invK", "target_id", "source_ids", "width", "height"):
            if hasattr(first, attr):
                setattr(self, attr, getattr(first, attr))

    def __len__(self) -> int:
        return self.bins[-1]

    @property
    def supports_item_K(self) -> bool:
        """True when EVERY item in the chain can resolve an intrinsics
        matrix — the fail-fast precondition for per_item_K (a chain that
        passes a shallow hasattr check but contains one K-less child would
        otherwise crash mid-epoch inside a loader worker thread)."""
        return all(resolves_item_K(d) for d in self.datasets)

    @property
    def heterogeneous_K(self) -> bool:
        """True when children carry genuinely different intrinsics — the case
        the reference's first-child-K approximation (src/Monodepth.jl:99)
        silently miscalibrates. Feed fit(per_item_K=True) then.

        Recurses into nested chains: a child chain's own heterogeneity counts
        (its copied first-grandchild K would otherwise mask it)."""
        if any(getattr(d, "heterogeneous_K", False) for d in self.datasets):
            return True
        Ks = [np.asarray(d.K) for d in self.datasets if hasattr(d, "K")]
        return len(Ks) == len(self.datasets) and any(
            not np.array_equal(Ks[0], k) for k in Ks[1:]
        )

    def K_of(self, i: int) -> np.ndarray:
        """Per-item intrinsics: the OWNING child's K (3,3) for global index i.

        Children may themselves define K_of (nested chains); otherwise their
        constant K applies to all their items."""
        if i < 0 or i >= len(self):
            raise IndexError(i)
        bid = bisect.bisect_right(self.bins, i)
        local = i - (self.bins[bid - 1] if bid > 0 else 0)
        ds = self.datasets[bid]
        if hasattr(ds, "K_of"):
            return np.asarray(ds.K_of(local), np.float32)
        if not hasattr(ds, "K"):
            raise ValueError(
                f"DChain child #{bid} ({type(ds).__name__}) exposes neither "
                "K_of nor K — per-item intrinsics cannot be resolved for "
                f"global index {i}"
            )
        return np.asarray(ds.K, np.float32)

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        if i < 0 or i >= len(self):
            raise IndexError(i)
        bid = bisect.bisect_right(self.bins, i)
        local = i - (self.bins[bid - 1] if bid > 0 else 0)
        ds = self.datasets[bid]
        try:
            return ds.__getitem__(local, rng)
        except TypeError:
            return ds[local]
