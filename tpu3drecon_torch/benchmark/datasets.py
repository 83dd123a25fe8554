"""Dataset registry: named configs and lazy loaders.

Counterpart of ``tpu3drecon/benchmark/datasets.py`` and of the reference
registry (reference: src/benchmark_implementation/benchmark_datasets.py:
10-80): named ``DatasetConfig`` records for the IMW2020 scenes (Reichstag,
Sacre Coeur, St Peters Square; ground-truth and noised variants) resolved
against DATASETS_PATH, which load only when those scenes are on disk, and
the synthetic configs that generate scenes on the fly through the port's
COLMAP writer and reader.  The names and seeds are JAX's, so both
registries list the same datasets and build the same unnoised scenes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Optional

from tpu3drecon_torch.config import DATASETS_PATH
from tpu3drecon_torch.dataset.scene import Dataset


@dataclass(frozen=True)
class DatasetConfig:
    """A named, lazily-loadable dataset (reference benchmark_datasets.py:10-27)."""

    name: str
    loader: Callable[[], Dataset] = field(repr=False)
    sparse_path: Optional[str] = None
    images_path: Optional[str] = None
    noised: bool = False

    def load(self) -> Dataset:
        return self.loader()


def _colmap_loader(sparse: str, images: str, name: str) -> Dataset:
    from tpu3drecon_torch.dataset.loader import load_colmap_dataset

    binary = os.path.exists(os.path.join(sparse, "cameras.bin"))
    return load_colmap_dataset(sparse, images, binary=binary, name=name)


def _synthetic_loader(
    name: str, n_cameras: int, n_points: int, noised: bool, seed: int
) -> Dataset:
    from tpu3drecon_torch.dataset.loader import load_colmap_dataset
    import tempfile

    from tpu3drecon_torch.dataset.synthetic import make_scene, scene_to_colmap_model
    from tpu3drecon_torch.io import colmap as cio

    scene = make_scene(n_cameras=n_cameras, n_points=n_points, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        cio.write_model(scene_to_colmap_model(scene), tmp, binary=True)
        ds = load_colmap_dataset(tmp, binary=True, name=name)
    if noised:
        ds = Dataset.with_noise(ds)
        ds.name = name
    return ds


def _imw2020_config(scene: str, noised: bool) -> DatasetConfig:
    suffix = "sparse_noised" if noised else "sparse"
    sparse = os.path.join(DATASETS_PATH, scene, suffix)
    images = os.path.join(DATASETS_PATH, scene, "images")
    name = f"{scene}{'_noised' if noised else ''}"
    return DatasetConfig(
        name=name,
        loader=partial(_colmap_loader, sparse, images, name),
        sparse_path=sparse,
        images_path=images,
        noised=noised,
    )


REGISTRY: Dict[str, DatasetConfig] = {}

# IMW2020 photo-tourism scenes (reference benchmark_datasets.py:30-66); these
# resolve only when the user has downloaded the datasets into DATASETS_PATH.
for _scene in ("reichstag", "sacre_coeur", "st_peters_square"):
    for _noised in (False, True):
        cfg = _imw2020_config(_scene, _noised)
        REGISTRY[cfg.name] = cfg

# Synthetic configs — always available.
for _name, _c, _p, _noised, _seed in [
    ("synthetic_small", 8, 300, False, 100),
    ("synthetic_small_noised", 8, 300, True, 100),
    ("synthetic_medium", 30, 3000, False, 101),
    ("synthetic_medium_noised", 30, 3000, True, 101),
]:
    REGISTRY[_name] = DatasetConfig(
        name=_name,
        loader=partial(_synthetic_loader, _name, _c, _p, _noised, _seed),
        noised=_noised,
    )


def get_dataset(name: str) -> Dataset:
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name].load()


def available(include_disk_gated: bool = False):
    """Names that can actually load in this environment."""
    out = []
    for name, cfg in REGISTRY.items():
        if cfg.sparse_path is None:
            out.append(name)
        elif include_disk_gated or os.path.isdir(cfg.sparse_path):
            out.append(name)
    return sorted(out)
