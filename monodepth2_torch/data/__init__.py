"""Host-side data layer, port of monodepth2_tpu/data: triplet datasets, the
async batched loader and the pinned, side-stream copy to the card.

Reference: src/kitty.jl (KittyDataset), src/dtk.jl (Depth10k, find_static),
src/dchain.jl (DChain), DataLoaders.jl usage at src/Monodepth.jl:130,153.
Datasets yield numpy (L,H,W,C) float32 triplets. KITTI and Depth10k files
decode through the native decoder (`data.native`, built at first use) or,
where it does not build, through PIL, imported only where a file is decoded.
"""

from .augment import Compose, FlipX, resize_bilinear
from .dchain import DChain, resolves_item_K
from .depth10k import Depth10k, find_static
from .kitti import KittiDataset
from .loader import DataLoader, accepts_rng, device_prefetch, placement_prefetch
from .synthetic import SyntheticDriving, SyntheticGroundPlane, SyntheticTriplets

__all__ = [
    "Compose",
    "FlipX",
    "resize_bilinear",
    "DChain",
    "resolves_item_K",
    "Depth10k",
    "find_static",
    "KittiDataset",
    "DataLoader",
    "accepts_rng",
    "device_prefetch",
    "placement_prefetch",
    "SyntheticDriving",
    "SyntheticGroundPlane",
    "SyntheticTriplets",
]
