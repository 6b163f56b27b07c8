"""FLAME asset loading (host side; port of ``avi_talking_tpu/core/assets.py``
``load_flame_assets`` and ``synthetic_assets``).

``synthetic_assets`` makes the same numpy draws in the same order as the
JAX version, so one seed gives the same arrays in both packages. Assets come
back as CPU tensors; the head moves them to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .flame import FLAME_NUM_JOINTS, FlameAssets

_LANDMARK_FIELDS = (
    "lmk_faces_idx",
    "lmk_bary_coords",
    "dynamic_lmk_faces_idx",
    "dynamic_lmk_bary_coords",
    "full_lmk_faces_idx",
    "full_lmk_bary_coords",
    "mediapipe_lmk_faces_idx",
    "mediapipe_lmk_bary_coords",
)


def load_flame_assets(npz_path: str, n_shape: int = 100, n_exp: int = 50) -> FlameAssets:
    """Load a converted FLAME npz, slicing shapedirs to
    [0:n_shape] ++ [300:300+n_exp] like the reference."""
    z = np.load(npz_path)
    shapedirs = z["shapedirs"]
    if shapedirs.shape[-1] >= 300 + n_exp:
        shapedirs = np.concatenate(
            [shapedirs[:, :, :n_shape], shapedirs[:, :, 300: 300 + n_exp]], axis=2)
    kw = {k: torch.from_numpy(np.asarray(z[k])) for k in _LANDMARK_FIELDS if k in z}
    return FlameAssets(
        v_template=torch.from_numpy(np.asarray(z["v_template"])),
        shapedirs=torch.from_numpy(np.ascontiguousarray(shapedirs)),
        posedirs=torch.from_numpy(np.asarray(z["posedirs"])),
        j_regressor=torch.from_numpy(np.asarray(z["j_regressor"])),
        lbs_weights=torch.from_numpy(np.asarray(z["lbs_weights"])),
        faces=torch.from_numpy(np.asarray(z["faces"])),
        **kw,
    )


def _random_bary(rng, shape) -> np.ndarray:
    b = rng.random(shape + (3,)).astype(np.float32)
    return b / b.sum(axis=-1, keepdims=True)


def synthetic_assets(
    num_vertices: int = 128,
    n_shape: int = 8,
    n_exp: int = 6,
    num_faces: int = 64,
    seed: int = 0,
    with_landmarks: bool = True,
    n_static_landmarks: int = 16,
) -> FlameAssets:
    """Small random-but-structurally-valid FLAME-like model."""
    rng = np.random.default_rng(seed)
    J = FLAME_NUM_JOINTS
    v_template = rng.standard_normal((num_vertices, 3)).astype(np.float32) * 0.1
    shapedirs = rng.standard_normal((num_vertices, 3, n_shape + n_exp)).astype(np.float32) * 0.01
    posedirs = rng.standard_normal(((J - 1) * 9, num_vertices * 3)).astype(np.float32) * 0.001
    j_regressor = rng.random((J, num_vertices)).astype(np.float32)
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    w = rng.random((num_vertices, J)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    faces = rng.integers(0, num_vertices, (num_faces, 3)).astype(np.int32)

    kw = {}
    if with_landmarks:
        L = n_static_landmarks
        kw = dict(
            lmk_faces_idx=rng.integers(0, num_faces, (L,)).astype(np.int32),
            lmk_bary_coords=_random_bary(rng, (L,)),
            dynamic_lmk_faces_idx=rng.integers(0, num_faces, (79, 17)).astype(np.int32),
            dynamic_lmk_bary_coords=_random_bary(rng, (79, 17)),
            full_lmk_faces_idx=rng.integers(0, num_faces, (L,)).astype(np.int32),
            full_lmk_bary_coords=_random_bary(rng, (L,)),
            mediapipe_lmk_faces_idx=rng.integers(0, num_faces, (21,)).astype(np.int32),
            mediapipe_lmk_bary_coords=_random_bary(rng, (21,)),
        )
    return FlameAssets(
        v_template=torch.from_numpy(v_template),
        shapedirs=torch.from_numpy(shapedirs),
        posedirs=torch.from_numpy(posedirs),
        j_regressor=torch.from_numpy(j_regressor),
        lbs_weights=torch.from_numpy(w),
        faces=torch.from_numpy(faces),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
