"""FLAME head model, linear blend skinning (port of the vertices path of
``avi_talking_tpu/core/flame.py``: ``FlameAssets``, ``lbs`` and
``FlameModel.vertices_only``; landmarks come in a later slice).

Pose layout [global(3), neck(3), jaw(3), eyes(6)] in axis-angle; betas =
concat[shape, expression].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .rotations import batch_rodrigues

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning -> (vertices (B, V, 3), posed joints (B, J, 3))."""
    B = betas.shape[0]
    J = assets.num_joints
    v_shaped = assets.v_template[None] + blend_shapes(betas, assets.shapedirs)
    joints = vertices2joints(assets.j_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, J, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ assets.posedirs).reshape(B, -1, 3)

    posed_joints, rel_tf = _rigid_transform_chain(rot_mats, joints, FLAME_PARENTS[:J])
    T = torch.einsum("vj,bjpq->bvpq", assets.lbs_weights, rel_tf)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", T, v_h)[..., :3]
    return verts, posed_joints


@dataclasses.dataclass(frozen=True)
class FlameModel:
    """FLAME decoder; ``vertices_only(shape, exp, pose)`` with pose (B, 6) =
    [global(3), jaw(3)] is the generate path's hot path."""

    assets: FlameAssets
    n_shape: int = 100
    n_exp: int = 50

    def full_pose(self, pose_params: torch.Tensor) -> torch.Tensor:
        B = pose_params.shape[0]
        z = pose_params.new_zeros
        return torch.cat([pose_params[:, :3], z(B, 3), pose_params[:, 3:], z(B, 6)], dim=1)

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
