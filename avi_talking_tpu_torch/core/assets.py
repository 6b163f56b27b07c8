"""FLAME asset conversion and loading (host side; port of
``avi_talking_tpu/core/assets.py``: ``convert_flame_pickle``,
``default_assets_path``, ``load_flame_assets`` and ``synthetic_assets``).

``convert_flame_pickle`` turns the user's FLAME ``generic_model.pkl`` (and
the landmark embeddings) into the npz that ``load_flame_assets`` and
``--flame-npz`` read, once, with numpy only.

``synthetic_assets`` makes the same numpy draws in the same order as the
JAX version, so one seed gives the same arrays in both packages. Assets come
back as CPU tensors; the head moves them to its device.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

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


def _to_np(x) -> np.ndarray:
    """numpy of an array-like: scipy sparse (``toarray``), chumpy (``.r``)
    or plain."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "r"):
        return np.asarray(x.r)
    return np.asarray(x)


def convert_flame_pickle(model_path: str, out_path: str,
                         lmk_embedding_path: Optional[str] = None,
                         mediapipe_lmk_embedding_path: Optional[str] = None) -> str:
    """FLAME's ``generic_model.pkl`` (latin-1 pickle) and optional landmark
    embedding npys -> one compressed npz: ``v_template``, ``shapedirs``,
    ``posedirs`` as (n_pose_basis, V*3), ``j_regressor``, ``lbs_weights``,
    ``faces`` and the landmark tables, in the dtypes and layouts JAX's
    converter writes."""
    with open(model_path, "rb") as f:
        m = pickle.load(f, encoding="latin1")
    posedirs = _to_np(m["posedirs"]).astype(np.float32)
    num_pose_basis = posedirs.shape[-1]
    arrays = {
        "v_template": _to_np(m["v_template"]).astype(np.float32),
        "shapedirs": _to_np(m["shapedirs"]).astype(np.float32),
        "posedirs": posedirs.reshape(-1, num_pose_basis).T.copy(),
        "j_regressor": _to_np(m["J_regressor"]).astype(np.float32),
        "lbs_weights": _to_np(m["weights"]).astype(np.float32),
        "faces": _to_np(m["f"]).astype(np.int32),
    }
    if lmk_embedding_path:
        lmk = np.load(lmk_embedding_path, allow_pickle=True, encoding="latin1")[()]
        arrays.update(
            lmk_faces_idx=np.asarray(lmk["static_lmk_faces_idx"]).astype(np.int32),
            lmk_bary_coords=np.asarray(lmk["static_lmk_bary_coords"]).astype(np.float32),
            dynamic_lmk_faces_idx=np.asarray(lmk["dynamic_lmk_faces_idx"]).astype(np.int32),
            dynamic_lmk_bary_coords=np.asarray(
                lmk["dynamic_lmk_bary_coords"]).astype(np.float32),
            full_lmk_faces_idx=np.asarray(lmk["full_lmk_faces_idx"]).reshape(-1).astype(np.int32),
            full_lmk_bary_coords=np.asarray(
                lmk["full_lmk_bary_coords"]).reshape(-1, 3).astype(np.float32),
        )
    if mediapipe_lmk_embedding_path:
        mp = np.load(mediapipe_lmk_embedding_path, allow_pickle=True, encoding="latin1")
        arrays.update(
            mediapipe_lmk_faces_idx=np.asarray(mp["lmk_face_idx"]).astype(np.int32),
            mediapipe_lmk_bary_coords=np.asarray(mp["lmk_b_coords"]).astype(np.float32),
        )
    np.savez_compressed(out_path, **arrays)
    return out_path


def default_assets_path() -> Optional[str]:
    """FLAME assets from ``AVI_TALKING_FLAME_NPZ`` or the checkout's
    ``assets/flame.npz``, else None."""
    for cand in (
        os.environ.get("AVI_TALKING_FLAME_NPZ"),
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "flame.npz"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


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
