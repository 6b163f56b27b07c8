"""train-faceformer-vert: vertex-space FaceFormer training (port of
``avi_talking_tpu/cli/train_faceformer_vert.py``).

Batches come from one of three sources, drawn in the JAX command's order:
synthetic (``np.random.default_rng(--seed)``), a VOCASET root (``--root``),
or a MEAD / EMOCA root (``--mead-root``: normalised coefficients decoded to
FLAME vertices in the step). ``--disentangle`` adds the cross-modal shuffle
terms (region masks from the FLAME assets, else thresholded from the data
template); ``--emo-cls`` the rendered emotion cross-entropy through the
frozen FAN tower and head; ``--emo-cls-pretrain`` trains only the head, on
renders of the ground truth. The optimizer is ``optax.adam``'s
(``train.optim.adam``). Checkpoints are ``torch.save`` files
(``infra.checkpoint``): ``--ckpt-dir`` writes ``{"params": ...}``, or
``{"emo_cls_head": ...}`` after the pretrain stage, which
``--head-checkpoint`` reads; ``--fan-checkpoint`` is a reference torch FAN
state dict. The permutations of the shuffle terms come from a
``torch.Generator`` seeded by ``--seed`` (JAX draws them from
``PRNGKey(step)``).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, NamedTuple, Optional

# Flags the JAX command parses (through the shared parser) and never reads:
# the port takes them too, and says on stderr that it ignores them.
IGNORED = {
    "bf16": "--bf16 is ignored, as in the JAX command: the run computes in float32",
    "checkpoint": "--checkpoint is ignored, as in the JAX command: the run starts from "
                  "seeded random weights (--head-checkpoint and --fan-checkpoint load the "
                  "frozen towers)",
}


class Source(NamedTuple):
    """A batch source: ``batch()`` -> (audio (B, T*640), payload, one_hot (B,
    n_subj), emo_idx (B,)) on the device, where the payload is vertices
    (B, T, vert_dim), or for MEAD normalised coefficients that ``to_verts``
    decodes."""

    batch: Callable[[], tuple]
    batch_size: int
    vert_dim: int
    template: object  # (vert_dim,) tensor
    n_subj: int
    assets: Optional[object]  # FlameAssets (CPU) for MEAD
    to_verts: Callable


def mead_flame_assets(tiny: bool, flame_npz: Optional[str]):
    """The FLAME the MEAD source decodes with: the tiny synthetic one, else
    ``--flame-npz`` or the default assets (required at full size)."""
    from ..core.assets import default_assets_path, load_flame_assets, synthetic_assets

    if tiny:
        return synthetic_assets(n_shape=8, n_exp=6), 8, 6
    npz = flame_npz or default_assets_path()
    if not npz:
        raise SystemExit("--mead-root needs FLAME assets (--flame-npz) at full size")
    return load_flame_assets(npz, 100, 50), 100, 50


def batch_source(args, rng, device) -> Source:
    import os

    import numpy as np
    import torch

    B, T = args.batch_size, args.frames

    def dev(a):
        return torch.as_tensor(a).to(device)

    if args.mead_root:
        from ..core.flame import FlameModel
        from ..data import MeadEmocaDataset, batch_iterator
        from ..data.stats import CoeffStats
        from ..data.train_batches import FaceFormerBatchBuilder
        from ..models.faceformer_vert import convert_coeff2verts

        assets, n_shape, n_exp = mead_flame_assets(args.tiny, args.flame_npz)
        flame = FlameModel(assets.to(device), n_shape=n_shape, n_exp=n_exp)
        ds = MeadEmocaDataset(root=args.mead_root, seq_length=T)
        builder = FaceFormerBatchBuilder(ds, frames=T, coeff_dim=n_exp + 3, load_images=False)
        if len(builder) == 0:
            raise SystemExit(f"no usable MEAD clips under {args.mead_root}")
        B = min(B, len(builder))
        batches = batch_iterator(builder, batch_size=B, epochs=None)
        stats = ds.stats or CoeffStats.identity(59)
        mean, std = dev(stats.mean), dev(stats.std)
        z = torch.zeros
        template = flame.vertices_only(z(1, n_shape, device=device), z(1, n_exp, device=device),
                                       z(1, 6, device=device)).reshape(-1)

        def batch():
            b = next(batches)
            return (dev(b["audio"]), dev(b["coeff"]), torch.zeros(B, 1, device=device),
                    dev(b["emo_idx"]))

        def to_verts(payload):  # (B, T, n_exp + 3) normalised -> (B, T, V*3)
            flat = payload.reshape(-1, payload.shape[-1])
            return convert_coeff2verts(flame, flat, mean, std).reshape(
                payload.shape[0], payload.shape[1], -1)

        return Source(batch, B, int(template.shape[0]), template, 1, assets, to_verts)

    def identity(payload):
        return payload

    if args.root:
        from ..data.vocaset import VocasetDataset

        subjects = args.train_subjects.split(",") if args.train_subjects else None
        if subjects is None:  # VOCASET names: <subject>_sentenceNN.wav
            wavs = sorted(os.listdir(os.path.join(args.root, "wav")))
            subjects = sorted({w.rsplit("_sentence", 1)[0] for w in wavs if "_sentence" in w})
            print(f"train-faceformer-vert: autodetected subjects {subjects}")
        ds = VocasetDataset(args.root, train_subjects=subjects, val_subjects=subjects[:1],
                            test_subjects=subjects[:1], dataset_kind=args.dataset_kind,
                            split="train")
        if not ds.items:
            raise SystemExit(f"no usable VOCASET clips under {args.root}")
        vert_dim = ds.items[0].vertice.shape[1]

        def batch():
            idxs = rng.integers(0, len(ds.items), size=B)
            audio = np.zeros((B, T * 640), np.float32)
            verts = np.zeros((B, T, vert_dim), np.float32)
            for j, k in enumerate(idxs):
                it = ds.items[k]
                L = it.vertice.shape[0]
                if L > T:
                    s = int(rng.integers(0, L - T + 1))
                    win = it.vertice[s:s + T]
                else:
                    s, win = 0, it.vertice
                a = it.audio[s * 640:(s + win.shape[0]) * 640]
                audio[j, :a.shape[0]] = a
                verts[j, :win.shape[0]] = win
                if win.shape[0] < T:  # edge-pad short clips
                    verts[j, win.shape[0]:] = win[-1]
            one_hot = np.stack([ds.items[k].one_hot for k in idxs])
            return dev(audio), dev(verts), dev(one_hot), torch.zeros(B, dtype=torch.int32,
                                                                     device=device)

        return Source(batch, B, vert_dim, dev(ds.items[0].template), len(ds.train_subjects),
                      None, identity)

    vert_dim = 30 if args.tiny else 15069
    template = dev(rng.standard_normal(vert_dim).astype(np.float32) * 0.01)
    n_subj = 2

    def batch():
        return (dev(rng.standard_normal((B, T * 640)).astype(np.float32)),
                dev(rng.standard_normal((B, T, vert_dim)).astype(np.float32) * 0.01),
                dev(np.eye(n_subj, dtype=np.float32)[rng.integers(0, n_subj, size=B)]),
                torch.zeros(B, dtype=torch.int32, device=device))

    return Source(batch, B, vert_dim, template, n_subj, None, identity)


def region_selector(args, src: Source):
    """The disentangle terms' region masks: from the FLAME assets where the
    data is FLAME's 5023 vertices and assets are at hand, else thresholded
    from the data template."""
    from ..core.assets import default_assets_path, load_flame_assets
    from ..models.faceformer_vert import FlameRegionSelector

    npz = args.flame_npz or default_assets_path()
    if src.assets is not None and src.vert_dim == 15069:
        return FlameRegionSelector.from_assets(src.assets)
    if npz and src.vert_dim == 15069:
        return FlameRegionSelector.from_assets(load_flame_assets(npz, 100, 50))
    print("train-faceformer-vert: region masks thresholded from the data template "
          "(no FLAME assets)", file=sys.stderr)
    return template_selector(src.template)


def template_selector(template):
    """Region masks thresholded at the quantiles of a (V*3,) template's
    coordinates: frontal above its median z and lowest y quartile, the
    mouth below its median y, the eyes between its median and 95th
    percentile y."""
    import numpy as np

    from ..models.faceformer_vert import FlameRegionSelector

    v3 = template.detach().cpu().numpy().astype(np.float32).reshape(-1, 3)
    return FlameRegionSelector.from_template(
        v3, frontal_z=float(np.median(v3[:, 2])), face_y=float(np.quantile(v3[:, 1], 0.25)),
        mouth_y_max=float(np.median(v3[:, 1])), eye_y_min=float(np.median(v3[:, 1])),
        eye_y_max=float(np.quantile(v3[:, 1], 0.95)), eye_z=float(np.median(v3[:, 2])))


def build_emo_cls(args, src: Source, device, frames: int):
    """The frozen FAN tower (seed 1, or ``--fan-checkpoint``) and head (seed
    6, or ``--head-checkpoint``) over renders at 224^2 (64^2 tiny), every
    frame in the pretrain stage and every min(20, T)-th otherwise. At a
    random init the backbone's single-channel ``conv6`` is often negative
    everywhere, and its ReLU then zeroes the feature for every image (seeds
    0, 2 and 5 at 64^2 and 224^2): the loss would be a constant with no
    gradient. Seed 1 gives a live tower at both sizes."""
    from ..infra.checkpoint import load_frozen_tower, restore_checkpoint
    from ..models.fan_encoder import FanEncoder
    from ..train.emo_cls import EmoClsHead, EmoClsLoss

    fan_size = 64 if args.tiny else 224
    fan = FanEncoder.random_init(fan_size, seed=1, device=device)
    if args.fan_checkpoint:
        load_frozen_tower(fan, args.fan_checkpoint)
    else:
        print("train-faceformer-vert: no --fan-checkpoint; the frozen FAN/cls towers are "
              "RANDOM-init (smoke semantics)", file=sys.stderr)
    head = EmoClsHead.random_init(seed=6, device=device)
    if args.head_checkpoint:
        head.load_state_dict(restore_checkpoint(args.head_checkpoint)["emo_cls_head"])
    return EmoClsLoss(faces=src.assets.faces.to(device), fan=fan, head=head,
                      render_size=fan_size, fan_size=fan_size,
                      stride=1 if args.emo_cls_pretrain else min(20, frames))


def model_config(args, src: Source):
    from ..audio.wav2vec2 import Wav2Vec2Config
    from ..models.faceformer_vert import FaceFormerVertConfig

    return FaceFormerVertConfig(
        vertice_dim=src.vert_dim, feature_dim=32 if args.tiny else 64,
        period=5 if args.tiny else 30, num_train_subjects=src.n_subj,
        wav2vec2=Wav2Vec2Config.tiny() if args.tiny else Wav2Vec2Config())


def cmd_train_faceformer_vert(args) -> int:
    import numpy as np
    import torch

    from ..infra.checkpoint import save_checkpoint
    from ..infra.device import resolve_device
    from ..models.faceformer_vert import FaceFormerVert
    from ..train.emo_cls import emo_cls_trainables
    from ..train.faceformer_vert_trainer import EmoClsPretrainer, FaceFormerVertTrainer
    from ..train.optim import adam

    for name, note in IGNORED.items():
        if getattr(args, name, None):
            print(f"train-faceformer-vert: {note}", file=sys.stderr)
    if (args.emo_cls or args.emo_cls_pretrain) and not args.mead_root:
        raise SystemExit("--emo-cls / --emo-cls-pretrain need --mead-root (MEAD emotion labels)")
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    src = batch_source(args, rng, device)
    B, T = src.batch_size, args.frames
    emo_cls = (build_emo_cls(args, src, device, T)
               if args.emo_cls or args.emo_cls_pretrain else None)

    if args.emo_cls_pretrain:
        head = emo_cls.head
        pre = EmoClsPretrainer(emo_cls, head, adam(emo_cls_trainables(head), args.lr),
                               src.to_verts)
        for i in range(args.steps):
            _, payload, _, emo_idx = src.batch()
            loss = pre.train_step(payload, emo_idx)
            if (i + 1) % 50 == 0:
                print(f"pretrain step {i+1}: emo_cls={float(loss):.4f}")
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, {"emo_cls_head": head.state_dict()})
        print("final:", {"emo_cls": float(loss)})
        return 0

    cfg = model_config(args, src)
    src.batch()  # the JAX command draws its first batch to initialise the params
    emo0 = torch.zeros(B, T, cfg.emo_dim, device=device)
    model = FaceFormerVert.random_init(cfg, template=src.template, seed=args.seed, device=device)
    trainer = FaceFormerVertTrainer(
        model=model, optimizer=adam(model.parameters(), args.lr), to_verts=src.to_verts,
        selector=region_selector(args, src) if args.disentangle else None, emo_cls=emo_cls)
    generator = torch.Generator().manual_seed(args.seed)
    terms = {}
    t0 = time.time()
    for i in range(args.steps):
        audio, payload, one_hot, emo_idx = src.batch()
        emo = (torch.from_numpy(rng.standard_normal((B, T, cfg.emo_dim)).astype(np.float32)
                                ).to(device) if args.disentangle else emo0)
        terms = trainer.train_step(audio, payload, one_hot, emo, emo_idx, generator=generator)
        if (i + 1) % 50 == 0:
            loss = sum(float(v) for v in terms.values())
            print(f"step {i+1}: loss={loss:.5f} ({(i+1)/(time.time()-t0):.1f} it/s)")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, {"params": model.state_dict()})
    print("final:", {k: float(v) for k, v in terms.items()})
    return 0


def register(sub, common):
    tv = sub.add_parser("train-faceformer-vert",
                        help="vertex-space FaceFormer training (synthetic, VOCASET or MEAD)")
    tv.add_argument("--steps", type=int, default=200)
    tv.add_argument("--batch-size", type=int, default=4)
    tv.add_argument("--frames", type=int, default=100)
    tv.add_argument("--lr", type=float, default=1e-4)
    tv.add_argument("--root", default=None,
                    help="VOCASET-style root (wav/ + vertices_npy/ + templates.pkl)")
    tv.add_argument("--train-subjects", default=None,
                    help="comma-separated subject names (default: autodetect)")
    tv.add_argument("--dataset-kind", default="vocaset", choices=("vocaset", "BIWI"))
    tv.add_argument("--disentangle", action="store_true",
                    help="cross-modal shuffle losses (eye / mouth region MSE)")
    tv.add_argument("--mead-root", default=None,
                    help="MEAD / EMOCA root: coefficients decoded to FLAME vertices in the step")
    tv.add_argument("--emo-cls", action="store_true",
                    help="emotion cross-entropy on rendered predicted frames through the frozen "
                         "FAN tower (needs --mead-root)")
    tv.add_argument("--emo-cls-pretrain", action="store_true",
                    help="train only the emo-cls head on ground-truth renders (needs --mead-root)")
    tv.add_argument("--head-checkpoint", default=None,
                    help="checkpoint directory of a pretrained emo_cls_head (--ckpt-dir of "
                         "--emo-cls-pretrain)")
    tv.add_argument("--fan-checkpoint", default=None,
                    help="reference torch FanEncoder state dict for the frozen emo-cls tower "
                         "(random-init without it)")
    tv.add_argument("--ckpt-dir", default=None)
    common(tv)
    tv.set_defaults(fn=cmd_train_faceformer_vert)
