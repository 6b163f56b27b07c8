"""Command-line interface of the port (``python -m avi_talking_tpu_torch.cli``).

Subcommands:
  generate   one (wav, instruction) pair -> coeffs npz (+ normal-map video
             with --save-video)
  instruct   over a caption corpus (experiments/json_dir format), one
             generate per caption
  portrait   PIRender photoreal portrait video from generate's coeff npz (or a
             --control sweep of the rotation / expression semantics) and a
             source portrait (--net-g: a reference net_G)
  serve      the same corpus through the micro-batching InferenceServer
             (batch coalescing, warmup, p50 / p99)
  diversity  the mean pairwise distance of N styles sampled for one
             instruction (sample i seeded --seed + i)
  train-faceformer
             stage-1 FaceFormer training (AdamW) on synthetic batches or a
             MEAD tree (--root, conditioned by the frozen FAN's eye and
             emotion embeddings of the detection crops), with the FLAME
             landmark terms given --flame-npz at full size, and under --root
             the PIRender render term (--render-loss) and EmoNet's term on
             its renders (--emo-loss, --emonet-checkpoint)
  train-faceformer-vert
             vertex-space FaceFormer training (Adam) on synthetic, VOCASET
             (--root) or MEAD (--mead-root) batches, with the disentangle
             shuffle terms and the rendered emotion loss through the frozen
             FAN tower (--emo-cls, --emo-cls-pretrain)
  train-flint
             FLINT motion-prior training (VAE, or VQ-VAE with --vq) on
             synthetic motion or a MEAD tree's exp + jaw windows (--root)
  train-emote
             staged EMOTE training (geometric, then condition exchange at
             lr / 2) on synthetic batches or a MEAD tree (--root, split by
             clip), with validation, best / last checkpoints and early
             stopping; --neural adds the rendered perceptual terms, --bf16
             trains the head and the towers at bfloat16 compute
  train-prior
             diffusion-prior training (clipped AdamW, one-cycle schedule)
             on the structured synthetic stream or a caption corpus
             (--json-dir / --root through the frozen CLIP text tower and
             style encoder), with validation, best / last checkpoints and
             --resume (--pipeline-checkpoint / --emote-checkpoint: the frozen
             towers' weights)
  train-pirender
             PIRender training (warp stage, then the editing stage with the
             style term, --gan: hinge GAN + feature matching) on synthetic
             pairs or a MEAD tree's video pairs (--root, --cross-id)
  train-emoca
             EMOCA / DECA self-supervised training over an image folder
             (--root) or synthetic batches: the coarse stage (--exp-only,
             --emo-loss) or the detail stage (--detail)
  reconstruct
             image(s) -> EMOCA codes -> FLAME -> shaded renders (--textured,
             --detail: the UV-textured and detail-normal renders)
  preprocess-mead
             raw frame folders or videos (--videos, through ffmpeg) -> the
             EMOCA-preprocessed MEAD layout: pseudo-GT codes, FAN landmarks,
             the full-frame face crop (--full-frames, S3FD boxes with
             --sfd-ckpt) and BiSeNet masks (--parse-faces)
  screen-videos
             CelebV-Text screening: expressive clips and their action
             intervals (--curated: the packaged action table)
  translate-captions
             Style-B CelebV-Text prose -> Style-A instructions, offline
  import-prior / import-emote / import-clip
             the reference's published prior .pth, EMOTE .ckpt and CLIP
             vocab (+ HF text weights) -> checkpoints --checkpoint reads
  convert-flame
             FLAME generic_model.pkl (+ landmark embeddings) -> the npz
             --flame-npz reads
  stats      MEAD coefficient mean / std

Everything runs on the CUDA card unless ``--device cpu`` is given; without
a card and without ``--device`` the commands raise. Weights are seeded
random unless ``--checkpoint`` gives them (repeatable: each checkpoint's
parts overwrite the seeded ones); ``--bf16`` computes in bfloat16 over
float32 weights, as the JAX package's ``--bf16`` does; ``--flame-npz``
gives real FLAME assets. The JAX package's ``bench`` is still to port.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from . import (importers, reconstruct, run, screen_videos, train, train_emoca, train_emote,
                   train_faceformer_vert, train_pirender, train_prior)
    from ._common import common_args

    p = argparse.ArgumentParser(prog="avi-talking-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    run.register(sub, common_args)
    for mod in (train, train_faceformer_vert, train_emote, train_prior, train_pirender,
                train_emoca, importers, reconstruct, screen_videos):
        mod.register(sub, common_args)
    args = p.parse_args(argv)
    return args.fn(args)
