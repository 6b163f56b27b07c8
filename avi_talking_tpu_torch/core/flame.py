"""FLAME head model (port of ``avi_talking_tpu/core/flame.py``):
``FlameAssets``, linear blend skinning, and ``FlameModel`` with its
landmarks (``vertices2landmarks``, the dynamic contour chosen from the neck
chain's y rotation, the 68-point 2D / 3D and the mediapipe sets), and
``FlameTex``, the PCA albedo.

Pose layout [global(3), neck(3), jaw(3), eyes(6)] in axis-angle; betas =
concat[shape, expression].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .rotations import batch_rodrigues, rot_mat_to_euler_y

FLAME_NUM_JOINTS = 5  # global, neck, jaw, eye_l, eye_r
FLAME_PARENTS = (-1, 0, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class FlameAssets:
    """FLAME model tensors (V vertices, J joints, F faces, L landmarks):
    v_template (V, 3); shapedirs (V, 3, n_shape + n_exp); posedirs
    ((J-1)*9, V*3); j_regressor (J, V); lbs_weights (V, J); faces (F, 3)
    int32; optional landmark embeddings."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    faces: torch.Tensor
    lmk_faces_idx: Optional[torch.Tensor] = None
    lmk_bary_coords: Optional[torch.Tensor] = None
    dynamic_lmk_faces_idx: Optional[torch.Tensor] = None
    dynamic_lmk_bary_coords: Optional[torch.Tensor] = None
    full_lmk_faces_idx: Optional[torch.Tensor] = None
    full_lmk_bary_coords: Optional[torch.Tensor] = None
    mediapipe_lmk_faces_idx: Optional[torch.Tensor] = None
    mediapipe_lmk_bary_coords: Optional[torch.Tensor] = None

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    def to(self, device) -> "FlameAssets":
        return FlameAssets(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, n) x (V, 3, n) -> (B, V, 3)."""
    v, three, n = shape_disps.shape
    return (betas @ shape_disps.reshape(v * three, n).T).reshape(betas.shape[0], v, three)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bvk,jv->bjk", vertices, j_regressor)


def _rigid_transform_chain(
    rot_mats: torch.Tensor,  # (B, J, 3, 3)
    joints: torch.Tensor,  # (B, J, 3)
    parents: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the static chain -> posed joints (B, J, 3)
    and relative transforms (B, J, 4, 4)."""
    B, J = joints.shape[:2]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1])]
        + [joints[:, parents[i]: parents[i] + 1] for i in range(1, J)], dim=1)

    def make_tf(R, t):  # (B, 3, 3), (B, 3) -> (B, 4, 4)
        top = torch.cat([R, t[:, :, None]], dim=2)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
        return torch.cat([top, bottom.expand(R.shape[0], 1, 4)], dim=1)

    transforms = [make_tf(rot_mats[:, 0], rel_joints[:, 0])]
    for i in range(1, J):
        transforms.append(transforms[parents[i]] @ make_tf(rot_mats[:, i], rel_joints[:, i]))
    transforms = torch.stack(transforms, dim=1)

    posed_joints = transforms[..., :3, 3]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    init_bone = transforms @ joints_h[..., None]  # (B, J, 4, 1)
    rel_transforms = transforms - torch.cat(
        [torch.zeros_like(transforms[..., :3]), init_bone], dim=-1)
    return posed_joints, rel_transforms


def lbs(
    betas: torch.Tensor,  # (B, n_shape + n_exp)
    pose: torch.Tensor,  # (B, J*3) axis-angle
    assets: FlameAssets,
    detach_pose_correctives: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning -> (vertices (B, V, 3), posed joints (B, J, 3)).
    ``detach_pose_correctives`` stops the gradient through the pose-corrective
    offsets (JAX's ``stop_gradient``)."""
    B = betas.shape[0]
    J = assets.num_joints
    v_shaped = assets.v_template[None] + blend_shapes(betas, assets.shapedirs)
    joints = vertices2joints(assets.j_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, J, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ assets.posedirs).reshape(B, -1, 3)
    if detach_pose_correctives:
        pose_offsets = pose_offsets.detach()
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_tf = _rigid_transform_chain(rot_mats, joints, FLAME_PARENTS[:J])
    T = torch.einsum("vj,bjpq->bvpq", assets.lbs_weights, rel_tf)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", T, v_h)[..., :3]
    return verts, posed_joints


def vertices2landmarks(
    vertices: torch.Tensor,  # (B, V, 3)
    faces: torch.Tensor,  # (F, 3) int
    lmk_faces_idx: torch.Tensor,  # (L,) or (B, L)
    lmk_bary_coords: torch.Tensor,  # (L, 3) or (B, L, 3)
) -> torch.Tensor:
    """Barycentric landmark interpolation -> (B, L, 3)."""
    B = vertices.shape[0]
    lmk_faces = faces.long()[lmk_faces_idx.long()]  # (L, 3) or (B, L, 3)
    if lmk_faces.dim() == 2:
        lmk_faces = lmk_faces.expand(B, *lmk_faces.shape)
    if lmk_bary_coords.dim() == 2:
        lmk_bary_coords = lmk_bary_coords.expand(B, *lmk_bary_coords.shape)
    rows = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[rows, lmk_faces]  # (B, L, 3 corners, 3)
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords)


def _neck_chain_indices(parents: Tuple[int, ...]) -> Tuple[int, ...]:
    """The joints from the neck up to the root: (1, 0) for FLAME."""
    chain = []
    idx = 1  # the neck
    while idx != -1:
        chain.append(idx)
        idx = parents[idx]
    return tuple(chain)


@dataclasses.dataclass(frozen=True)
class FlameModel:
    """FLAME decoder. ``vertices_only(shape, exp, pose)`` with pose (B, 6) =
    [global(3), jaw(3)] is the generate path's hot path; calling the model
    also returns the landmarks: (vertices, landmarks2d, landmarks3d), and
    the mediapipe set fourth with ``with_mediapipe``."""

    assets: FlameAssets
    n_shape: int = 100
    n_exp: int = 50
    with_mediapipe: bool = False

    def full_pose(
        self,
        pose_params: torch.Tensor,  # (B, 6) global + jaw
        eye_pose_params: Optional[torch.Tensor] = None,  # (B, 6)
        neck_pose: Optional[torch.Tensor] = None,  # (B, 3)
    ) -> torch.Tensor:
        B = pose_params.shape[0]
        if eye_pose_params is None:
            eye_pose_params = pose_params.new_zeros(B, 6)
        if neck_pose is None:
            neck_pose = pose_params.new_zeros(B, 3)
        return torch.cat([pose_params[:, :3], neck_pose, pose_params[:, 3:], eye_pose_params],
                         dim=1)

    def vertices_only(
        self,
        shape_params: torch.Tensor,
        expression_params: torch.Tensor,
        pose_params: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if pose_params is None:
            pose_params = shape_params.new_zeros(shape_params.shape[0], 6)
        betas = torch.cat([shape_params, expression_params], dim=1)
        verts, _ = lbs(betas, self.full_pose(pose_params), self.assets)
        return verts

    def _dynamic_landmarks(self, full_pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The contour landmarks' faces (B, 17) and barycentrics (B, 17, 3),
        picked by the neck chain's y rotation in whole degrees (rounded half
        to even, as ``jnp.round`` and ``torch.round`` both do; at most 39,
        and 78 below -39)."""
        assets = self.assets
        B = full_pose.shape[0]
        chain = _neck_chain_indices(FLAME_PARENTS[:assets.num_joints])
        aa = full_pose.reshape(B, -1, 3)[:, list(chain)]  # (B, C, 3)
        rots = batch_rodrigues(aa.reshape(-1, 3)).reshape(B, -1, 3, 3)
        rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(B, 3, 3)
        for i in range(len(chain)):
            rel = rots[:, i] @ rel
        # divided by a tensor: CUDA turns a division by a Python number into a
        # product with its reciprocal, which could move a knife-edge angle
        pi = torch.full((), math.pi, dtype=full_pose.dtype, device=full_pose.device)
        y = torch.round(torch.clamp(rot_mat_to_euler_y(rel) * 180.0 / pi, max=39.0)).long()
        idx = torch.where(y < 0, torch.where(y < -39, 78, 39 - y), y)  # (B,)
        return assets.dynamic_lmk_faces_idx[idx], assets.dynamic_lmk_bary_coords[idx]

    def __call__(
        self,
        shape_params: torch.Tensor,
        expression_params: Optional[torch.Tensor] = None,
        pose_params: Optional[torch.Tensor] = None,
        eye_pose_params: Optional[torch.Tensor] = None,
    ):
        B = shape_params.shape[0]
        if expression_params is None:
            expression_params = shape_params.new_zeros(B, self.n_exp)
        if pose_params is None:
            pose_params = shape_params.new_zeros(B, 6)
        betas = torch.cat([shape_params, expression_params], dim=1)
        fp = self.full_pose(pose_params, eye_pose_params)
        vertices, _ = lbs(betas, fp, self.assets)

        a = self.assets
        landmarks2d = landmarks3d = None
        if a.lmk_faces_idx is not None:
            lf, lb = a.lmk_faces_idx, a.lmk_bary_coords
            if a.dynamic_lmk_faces_idx is not None:
                dyn_idx, dyn_bary = self._dynamic_landmarks(fp)
                lf = torch.cat([dyn_idx, lf.expand(B, *lf.shape)], dim=1)
                lb = torch.cat([dyn_bary, lb.expand(B, *lb.shape)], dim=1)
            landmarks2d = vertices2landmarks(vertices, a.faces, lf, lb)
        if a.full_lmk_faces_idx is not None:
            landmarks3d = vertices2landmarks(vertices, a.faces, a.full_lmk_faces_idx,
                                             a.full_lmk_bary_coords)
        if self.with_mediapipe and a.mediapipe_lmk_faces_idx is not None:
            lmk_mp = vertices2landmarks(vertices, a.faces, a.mediapipe_lmk_faces_idx,
                                        a.mediapipe_lmk_bary_coords)
            return vertices, landmarks2d, landmarks3d, lmk_mp
        return vertices, landmarks2d, landmarks3d


@dataclasses.dataclass(frozen=True)
class FlameTex:
    """FLAME's PCA albedo model (gdl's FLAMETex): texture = mean + basis @
    texcode, (B, side, side, 3) in [0, 1] (the npz holds [0, 255]).

    The texture npz (``mean`` and ``tex_dir`` or ``basis``) is FLAME's
    external texture download; ``n_tex`` keeps the leading components."""

    texture_mean: torch.Tensor  # (side*side*3,)
    texture_basis: torch.Tensor  # (side*side*3, n_components)
    n_tex: int = 50

    @classmethod
    def from_npz(cls, path: str, n_tex: int = 50) -> "FlameTex":
        z = np.load(path)
        mean = np.asarray(z["mean"], np.float32).reshape(-1)
        basis = np.asarray(z["tex_dir"] if "tex_dir" in z else z["basis"],
                           np.float32).reshape(mean.shape[0], -1)
        return cls(torch.from_numpy(mean), torch.from_numpy(np.ascontiguousarray(basis[:, :n_tex])),
                   n_tex)

    def to(self, device) -> "FlameTex":
        return FlameTex(self.texture_mean.to(device), self.texture_basis.to(device), self.n_tex)

    def __call__(self, texcode: torch.Tensor) -> torch.Tensor:
        """(B, n_tex) -> (B, side, side, 3) albedo in [0, 1]."""
        flat = self.texture_mean[None] + texcode @ self.texture_basis[:, :self.n_tex].t()
        side = int(round((flat.shape[1] // 3) ** 0.5))
        tex = flat.reshape(texcode.shape[0], side, side, 3)
        return torch.clamp(tex / 255.0, 0.0, 1.0)
