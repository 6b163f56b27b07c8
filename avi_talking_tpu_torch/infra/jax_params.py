"""Carry weights from the JAX package to the port.

Takes flax parameter trees as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, pipeline.params)``) and returns ``state_dict``s of
the port's modules as numpy arrays. Layout maps:

* Dense kernel (in, out) -> Linear weight (out, in);
* Conv kernel (k, in, out) -> Conv1d weight (out, in, k); 2-D (kh, kw,
  in, out) -> Conv2d (out, in, kh, kw); 3-D DHWIO -> Conv3d OIDHW;
* ConvTranspose kernel (k, out, in) (``transpose_kernel=True``) ->
  ConvTranspose1d weight (in, out, k);
* LayerNorm / GroupNorm ``scale`` -> ``weight``;
* BatchNorm ``mean`` / ``var`` (``batch_stats``) -> ``running_mean`` /
  ``running_var``.

Layer counts and the squasher type are read from the trees' keys. This
module imports neither JAX nor the JAX package: it only reads arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

Tree = Mapping[str, Any]
State = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.array(x, order="C")  # a writable copy


def _dense(p: Tree) -> State:
    out = {"weight": _a(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def _conv(p: Tree) -> State:
    out = {"weight": _a(np.asarray(p["kernel"]).transpose(2, 1, 0))}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def _norm(p: Tree) -> State:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def _batchnorm(p: Tree, stats: Tree) -> State:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"]),
            "running_mean": _a(stats["mean"]), "running_var": _a(stats["var"]),
            "num_batches_tracked": np.zeros((), np.int64)}


def _put(out: State, prefix: str, sd: State) -> None:
    for k, v in sd.items():
        out[prefix + k] = v


def _count(p: Tree, stem: str) -> int:
    n = 0
    while f"{stem}{n}" in p:
        n += 1
    return n


def transformer_encoder_state_from_jax(params: Tree) -> State:
    """``ops.transformer.TransformerEncoder`` params -> port state."""
    out: State = {}
    for i in range(_count(params, "layers_")):
        lp, pre = params[f"layers_{i}"], f"layers.{i}."
        sa = lp["self_attn"]
        out[pre + "self_attn.in_proj_weight"] = _a(sa["in_proj_weight"])
        out[pre + "self_attn.in_proj_bias"] = _a(sa["in_proj_bias"])
        out[pre + "self_attn.out_proj.weight"] = _a(sa["out_proj_weight"])
        out[pre + "self_attn.out_proj.bias"] = _a(sa["out_proj_bias"])
        for name in ("linear1", "linear2"):
            _put(out, f"{pre}{name}.", _dense(lp[name]))
        for name in ("norm1", "norm2"):
            _put(out, f"{pre}{name}.", _norm(lp[name]))
    return out


def _attention(p: Tree) -> State:
    return {"in_proj_weight": _a(p["in_proj_weight"]), "in_proj_bias": _a(p["in_proj_bias"]),
            "out_proj.weight": _a(p["out_proj_weight"]), "out_proj.bias": _a(p["out_proj_bias"])}


def transformer_decoder_state_from_jax(params: Tree) -> State:
    """``ops.transformer.TransformerDecoder`` params -> port state."""
    out: State = {}
    for i in range(_count(params, "layers_")):
        lp, pre = params[f"layers_{i}"], f"layers.{i}."
        for name in ("self_attn", "multihead_attn"):
            _put(out, f"{pre}{name}.", _attention(lp[name]))
        for name in ("linear1", "linear2"):
            _put(out, f"{pre}{name}.", _dense(lp[name]))
        for name in ("norm1", "norm2", "norm3"):
            _put(out, f"{pre}{name}.", _norm(lp[name]))
    return out


def faceformer_state_from_jax(params: Tree) -> State:
    """``models.faceformer.FaceFormerCoeff`` params -> port state."""
    out: State = {"obj_embedding": _a(params["obj_embedding"])}
    _put(out, "audio_encoder.", wav2vec2_state_from_jax(params["audio_encoder"]))
    for name in ("audio_feature_map", "vertice_map", "vertice_map_r", "coeff2style",
                 "v_merge2hidden"):
        if name in params:
            _put(out, name + ".", _dense(params[name]))
    _put(out, "transformer_decoder.",
         transformer_decoder_state_from_jax(params["transformer_decoder"]))
    return out


def faceformer_vert_state_from_jax(params: Tree) -> State:
    """``models.faceformer_vert.FaceFormerVert`` params -> port state."""
    out: State = {"learnable_eye_embed": _a(params["learnable_eye_embed"])}
    _put(out, "audio_encoder.", wav2vec2_state_from_jax(params["audio_encoder"]))
    for name in ("audio_feature_map", "vertice_map", "vertice_map_r", "obj_vector",
                 "v_merge2hidden"):
        if name in params:
            _put(out, name + ".", _dense(params[name]))
    _put(out, "transformer_decoder.",
         transformer_decoder_state_from_jax(params["transformer_decoder"]))
    return out


def wav2vec2_state_from_jax(params: Tree) -> State:
    """``audio.wav2vec2.Wav2Vec2Model`` params -> port (HF-named) state;
    ``masked_spec_embed`` where the JAX tree has it (a model initialised
    with a time mask; the port's is built with ``mask_time=True``)."""
    out: State = {}
    if "masked_spec_embed" in params:
        out["masked_spec_embed"] = _a(params["masked_spec_embed"])
    fe = params["feature_extractor"]
    for i in range(_count(fe, "conv_layers_")):
        layer, pre = fe[f"conv_layers_{i}"], f"feature_extractor.conv_layers.{i}."
        _put(out, pre + "conv.", _conv(layer["conv"]))
        if "layer_norm" in layer:
            _put(out, pre + "layer_norm.", _norm(layer["layer_norm"]))
    fp = params["feature_projection"]
    _put(out, "feature_projection.layer_norm.", _norm(fp["layer_norm"]))
    _put(out, "feature_projection.projection.", _dense(fp["projection"]))
    # grouped pos conv: weight[o, i, t] = kernel[t, i, o]
    _put(out, "encoder.pos_conv_embed.conv.", _conv(params["pos_conv_embed"]["conv"]))
    _put(out, "encoder.layer_norm.", _norm(params["encoder_layer_norm"]))
    for i in range(_count(params, "layers_")):
        lp, pre = params[f"layers_{i}"], f"encoder.layers.{i}."
        for jax_name, name in (("attn_q", "q_proj"), ("attn_k", "k_proj"),
                               ("attn_v", "v_proj"), ("attn_out", "out_proj")):
            _put(out, f"{pre}attention.{name}.", _dense(lp[jax_name]))
        _put(out, pre + "layer_norm.", _norm(lp["layer_norm"]))
        _put(out, pre + "feed_forward.intermediate_dense.", _dense(lp["intermediate_dense"]))
        _put(out, pre + "feed_forward.output_dense.", _dense(lp["output_dense"]))
        _put(out, pre + "final_layer_norm.", _norm(lp["final_layer_norm"]))
    return out


def flint_state_from_jax(params: Tree, batch_stats: Tree) -> State:
    """``models.flint.FlintDecoder`` params + batch_stats -> port state."""
    out: State = {}
    i = 0
    while f"expander_{i}_conv" in params:
        # stage 0 is the ConvTranspose: (k, out, in) -> (in, out, k), the
        # inverse of infra/torch_compat.py::conv_transpose1d_params
        _put(out, f"expander.{i}.0.", _conv(params[f"expander_{i}_conv"]))
        _put(out, f"expander.{i}.2.", _batchnorm(
            params[f"expander_{i}_post"]["bn"], batch_stats[f"expander_{i}_post"]["bn"]))
        i += 1
    _put(out, "decoder_linear_embedding.", _dense(params["decoder_linear_embedding"]))
    _put(out, "decoder_transformer.", transformer_encoder_state_from_jax(params["decoder_transformer"]))
    for name in ("post_transformer_linear", "post_conv_proj"):
        if name in params:
            _put(out, name + ".", _dense(params[name]))
    _put(out, "cross_smooth_layer.", _conv(params["cross_smooth_layer"]))
    return out


def flint_vae_state_from_jax(variables: Tree) -> State:
    """``models.flint_vae.FlintVAE`` / ``FlintVQVAE`` variables ({"params",
    "batch_stats"}) -> port state, in ``L2lVqVae``'s names (``squasher.{i}``
    in the encoder, ``expander.{i}`` in the decoder)."""
    params, stats = variables["params"], variables["batch_stats"]
    enc, enc_stats = params["encoder"], stats["encoder"]
    out: State = {}
    i = 0
    while f"squasher_{i}_conv" in enc:
        _put(out, f"encoder.squasher.{i}.0.", _conv(enc[f"squasher_{i}_conv"]))
        _put(out, f"encoder.squasher.{i}.2.", _batchnorm(
            enc[f"squasher_{i}_post"]["bn"], enc_stats[f"squasher_{i}_post"]["bn"]))
        i += 1
    _put(out, "encoder.encoder_linear_embedding.", _dense(enc["encoder_linear_embedding"]))
    _put(out, "encoder.encoder_transformer.",
         transformer_encoder_state_from_jax(enc["encoder_transformer"]))
    for name in ("mean", "logvar"):
        if name in params:
            _put(out, name + ".", _dense(params[name]))
    if "quantizer" in params:
        out["quantizer.embedding"] = _a(params["quantizer"]["embedding"])
    _put(out, "decoder.", flint_state_from_jax(params["decoder"], stats["decoder"]))
    return out


def feed_forward_decoder_state_from_jax(params: Tree) -> State:
    """``models.decoders.FeedForwardDecoder`` params -> port state."""
    out: State = {}
    _put(out, "decoder.", _dense(params["decoder"]))
    for i in range(_count(params, "mlp_")):
        _put(out, f"mlp.{i}.", _dense(params[f"mlp_{i}"]))
    if "bert_decoder" in params:
        _put(out, "bert_decoder.", transformer_encoder_state_from_jax(params["bert_decoder"]))
    return out


def _gru_direction(cell: Tree, suffix: str) -> State:
    """flax ``GRUCell`` (dense ``ir iz in`` on the input, ``hr hz hn`` on the
    state; a recurrent bias on ``hn`` only) -> ``torch.nn.GRU``'s packed
    (r, z, n) weights of one direction; ``b_hr`` and ``b_hz`` are 0."""
    hn_bias = np.asarray(cell["hn"]["bias"])
    zero = np.zeros_like(hn_bias)
    return {
        f"weight_ih_l0{suffix}": _a(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in ("ir", "iz", "in")])),
        f"weight_hh_l0{suffix}": _a(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in ("hr", "hz", "hn")])),
        f"bias_ih_l0{suffix}": _a(np.concatenate(
            [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")])),
        f"bias_hh_l0{suffix}": _a(np.concatenate([zero, zero, hn_bias])),
    }


def sequence_encoder_state_from_jax(params: Tree) -> State:
    """``models.sequence_encoders`` (linear, transformer, GRU or TCN) params
    -> port state; the kind is read from the tree's keys."""
    out: State = {}
    if "GRUCell_0" in params:
        _put(out, "gru.", _gru_direction(params["GRUCell_0"], ""))
        if "GRUCell_1" in params:
            _put(out, "gru.", _gru_direction(params["GRUCell_1"], "_reverse"))
        return out
    if "linear" in params:
        _put(out, "linear.", _dense(params["linear"]))
        return out
    _put(out, "in_proj.", _dense(params["in_proj"]))
    if "encoder" in params:
        _put(out, "encoder.", transformer_encoder_state_from_jax(params["encoder"]))
    for i in range(_count(params, "conv")):
        _put(out, f"convs.{i}.", _conv(params[f"conv{i}"]))
    return out


def style_encoder_state_from_jax(params: Tree) -> State:
    """``models.conditioning.EmotionStyleEncoder`` params -> port state
    (``map.``): the style tower of the prior's caption featurizer."""
    return {"map." + k: v for k, v in _dense(params["map"]).items()}


def emote_head_state_from_jax(variables: Tree) -> State:
    """``models.emote.EmoteTalkingHead`` variables ({"params",
    "batch_stats"}) -> port state. The style encoder is carried when the JAX
    tree has it (it does only if the JAX head ever ran it)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: State = {}
    _put(out, "audio_encoder.", wav2vec2_state_from_jax(params["audio_encoder"]))
    _put(out, "sequence_encoder.", _dense(params["sequence_encoder"]))
    if "style_encoder" in params:
        _put(out, "style_encoder.", style_encoder_state_from_jax(params["style_encoder"]))
    if "bert_decoder" in params:
        _put(out, "bert_decoder.", transformer_encoder_state_from_jax(params["bert_decoder"]))
    _put(out, "decoder.", _dense(params["decoder"]))
    sq = params["squasher"]
    if "kernel" in sq:  # stack_linear
        _put(out, "squasher.", _dense(sq))
    else:  # conv squasher
        i = 0
        while f"stage{i}_conv" in sq:
            pre = f"squasher.squasher.{i}."
            _put(out, pre + "0.", _conv(sq[f"stage{i}_conv"]))
            _put(out, pre + "2.", _batchnorm(sq[f"stage{i}_bn"], stats["squasher"][f"stage{i}_bn"]))
            i += 1
    _put(out, "motion_prior.", flint_state_from_jax(params["motion_prior"], stats["motion_prior"]))
    return out


def _conv_nd(p: Tree) -> State:
    """A 2-D or 3-D flax conv kernel (..., in, out) -> (out, in, ...), and its
    bias where it has one."""
    k = np.asarray(p["kernel"])
    out = {"weight": _a(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def resnet50_state_from_jax(params: Tree, batch_stats: Tree) -> State:
    """``models.resnet.ResNet50`` params + batch_stats -> port state, under
    torchvision's names (``layer{l}.{b}.conv1``, ``downsample.0`` / ``.1``)."""
    out: State = {}
    _put(out, "conv1.", _conv_nd(params["conv1"]))
    _put(out, "bn1.", _batchnorm(params["bn1"]["bn"], batch_stats["bn1"]["bn"]))
    li = 1
    while f"layer{li}_0" in params:
        bi = 0
        while f"layer{li}_{bi}" in params:
            name, pre = f"layer{li}_{bi}", f"layer{li}.{bi}."
            p, s = params[name], batch_stats[name]
            for ci in (1, 2, 3):
                _put(out, f"{pre}conv{ci}.", _conv_nd(p[f"conv{ci}"]))
                _put(out, f"{pre}bn{ci}.", _batchnorm(p[f"bn{ci}"]["bn"], s[f"bn{ci}"]["bn"]))
            if "down_conv" in p:
                _put(out, pre + "downsample.0.", _conv_nd(p["down_conv"]))
                _put(out, pre + "downsample.1.", _batchnorm(p["down_bn"]["bn"], s["down_bn"]["bn"]))
            bi += 1
        li += 1
    return out


def emotion_module_state_from_jax(variables: Tree) -> State:
    """``models.emoca.EmotionRecognitionModule`` variables -> port state."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "backbone.", resnet50_state_from_jax(params["backbone"], stats["backbone"]))
    _put(out, "linear.", _dense(params["linear"]))
    return out


def lipread_state_from_jax(variables: Tree) -> State:
    """``models.lipread.LipReadingNet`` variables -> port state, under the
    reference's names (``frontend3D.0`` / ``.1``, ``trunk.layer{l}.{b}``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "frontend3D.0.", _conv_nd(params["frontend3d_conv"]))
    _put(out, "frontend3D.1.", _batchnorm(params["frontend3d_bn"], stats["frontend3d_bn"]))
    for li in range(1, 5):
        for bi in range(2):
            name, pre = f"layer{li}_{bi}", f"trunk.layer{li}.{bi}."
            p, s = params[name], stats[name]
            for c in ("1", "2"):
                _put(out, f"{pre}conv{c}.", _conv_nd(p[f"conv{c}"]))
                _put(out, f"{pre}bn{c}.", _batchnorm(p[f"bn{c}"], s[f"bn{c}"]))
            if "downsample_conv" in p:
                _put(out, pre + "downsample.0.", _conv_nd(p["downsample_conv"]))
                _put(out, pre + "downsample.1.", _batchnorm(p["downsample_bn"], s["downsample_bn"]))
    return out


def video_emotion_state_from_jax(params: Tree) -> State:
    """``models.video_emotion.VideoEmotionClassifier`` params -> port state."""
    out: State = {}
    _put(out, "in_proj.", _dense(params["in_proj"]))
    _put(out, "encoder.", transformer_encoder_state_from_jax(params["encoder"]))
    _put(out, "classifier.", _dense(params["classifier"]))
    return out


def _fan_convblock(p: Tree, s: Tree) -> State:
    out: State = {}
    for i in (1, 2, 3):
        _put(out, f"conv{i}.", _conv_nd(p[f"conv{i}"]))
        _put(out, f"bn{i}.", _batchnorm(p[f"bn{i}"]["bn"], s[f"bn{i}"]["bn"]))
    if "down_conv" in p:
        _put(out, "downsample.0.", _batchnorm(p["down_bn"]["bn"], s["down_bn"]["bn"]))
        _put(out, "downsample.2.", _conv_nd(p["down_conv"]))
    return out


def fan_encoder_state_from_jax(variables: Tree) -> State:
    """``models.fan_encoder.FanEncoder`` variables -> port state, under the
    reference torch names (``model.m0.b1_4``, ``to_mouth.2``, ...)."""
    params, stats = variables["params"], variables["batch_stats"]
    p, s = params["model"], stats["model"]
    out: State = {}
    for name in ("conv1", "conv_last0", "l0", "conv6"):
        _put(out, f"model.{name}.", _conv_nd(p[name]))
    for name in ("bn1", "bn_end0", "bn5"):
        _put(out, f"model.{name}.", _batchnorm(p[name]["bn"], s[name]["bn"]))
    for name in ("conv2", "conv3", "conv4", "top_m_0"):
        _put(out, f"model.{name}.", _fan_convblock(p[name], s[name]))
    for name in p["m0"]:
        _put(out, f"model.m0.{name}.", _fan_convblock(p["m0"][name], s["m0"][name]))
    _put(out, "model.fc.", _dense(p["fc"]))
    for head in ("mouth", "headpose", "eye", "emo"):
        hp, hs = params[head], stats[head]
        _put(out, f"to_{head}.0.", _dense(hp["to_dense0"]))
        _put(out, f"to_{head}.2.", _batchnorm(hp["to_bn"], hs["to_bn"]))
        _put(out, f"to_{head}.3.", _dense(hp["to_dense1"]))
        _put(out, f"{head}_embed.1.", _dense(hp["embed"]))
    return out


def emo_cls_head_state_from_jax(variables: Tree) -> State:
    """``train.emo_cls.EmoClsHead`` variables -> port state (``0``, ``2``, ``3``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "0.", _dense(params["fc0"]))
    _put(out, "2.", _batchnorm(params["bn"], stats["bn"]))
    _put(out, "3.", _dense(params["fc1"]))
    return out


def clip_text_state_from_jax(params: Tree) -> State:
    """``models.clip_text.ClipTextModel`` params -> port (HF-named) state."""
    out: State = {
        "embeddings.token_embedding.weight": _a(params["token_embedding"]["embedding"]),
        "embeddings.position_embedding.weight": _a(params["position_embedding"]),
    }
    for i in range(_count(params, "layers_")):
        lp, pre = params[f"layers_{i}"], f"encoder.layers.{i}."
        _put(out, pre + "layer_norm1.", _norm(lp["layer_norm1"]))
        _put(out, pre + "layer_norm2.", _norm(lp["layer_norm2"]))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put(out, f"{pre}self_attn.{name}.", _dense(lp[name]))
        _put(out, pre + "mlp.fc1.", _dense(lp["fc1"]))
        _put(out, pre + "mlp.fc2.", _dense(lp["fc2"]))
    _put(out, "final_layer_norm.", _norm(params["final_layer_norm"]))
    return out


def brain_state_from_jax(params: Tree) -> State:
    """``models.brain.BrainNetwork`` params -> port (reference-named) state."""
    out: State = {}
    _put(out, "lin0.0.", _dense(params["lin0_dense"]))
    _put(out, "lin0.1.", _norm(params["lin0_norm"]))
    i = 0
    while f"mlp_{i}_dense" in params:
        _put(out, f"mlp.{i}.0.", _dense(params[f"mlp_{i}_dense"]))
        _put(out, f"mlp.{i}.1.", _norm(params[f"mlp_{i}_norm"]))
        i += 1
    _put(out, "lin1.", _dense(params["lin1"]))
    if "proj_norm0" in params:
        for idx, name in ((0, "proj_norm0"), (3, "proj_norm1"), (6, "proj_norm2")):
            _put(out, f"projector.{idx}.", _norm(params[name]))
        for idx, name in ((2, "proj_dense1"), (5, "proj_dense2"), (8, "proj_dense3")):
            _put(out, f"projector.{idx}.", _dense(params[name]))
    return out


def prior_state_from_jax(params: Tree) -> State:
    """``models.prior_transformer.PriorTransformerNetwork`` params -> port
    (reference-named) state."""
    out: State = {k: _a(params[k]) for k in ("null_brain_embeds", "null_image_embed",
                                             "learned_query")}
    te = params["to_time_embeds"]
    _put(out, "to_time_embeds.0.1.net.0.0.", _dense(te["dense0"]))
    _put(out, "to_time_embeds.0.1.net.1.0.", _dense(te["dense1"]))
    _put(out, "to_time_embeds.0.1.net.2.", _dense(te["dense_out"]))
    ct, pre = params["causal_transformer"], "causal_transformer."
    out[pre + "rel_pos_bias.relative_attention_bias.weight"] = _a(
        ct["rel_pos_bias"]["relative_attention_bias"])
    for i in range(_count(ct, "attn_")):
        a, f, lp = ct[f"attn_{i}"], ct[f"ff_{i}"], f"{pre}layers.{i}."
        out[lp + "0.norm.g"] = _a(a["norm"]["g"])
        out[lp + "0.null_kv"] = _a(a["null_kv"])
        _put(out, lp + "0.to_q.", _dense(a["to_q"]))
        _put(out, lp + "0.to_kv.", _dense(a["to_kv"]))
        _put(out, lp + "0.to_out.0.", _dense(a["to_out"]))
        out[lp + "0.to_out.1.g"] = _a(a["out_norm"]["g"])
        out[lp + "1.0.g"] = _a(f["norm"]["g"])
        _put(out, lp + "1.1.", _dense(f["dense_in"]))
        _put(out, lp + "1.5.", _dense(f["dense_out"]))
    out[pre + "norm.g"] = _a(ct["norm_out"]["g"])
    _put(out, pre + "project_out.", _dense(ct["project_out"]))
    return out


def prior_trainer_state_from_jax(variables: Tree) -> Dict[str, State]:
    """The JAX prior trainer's params ({"brain", "prior"}, each a flax
    variables dict) -> {"brain", "prior"} states of the port's
    ``PriorTrainState`` (``BrainNetwork`` and the ``DiffusionPrior``'s
    network). Leaves need only be array-like: a tree of booleans (an optax
    mask) maps leaf by leaf."""
    return {"brain": brain_state_from_jax(variables["brain"]["params"]),
            "prior": prior_state_from_jax(variables["prior"]["params"])}


def pipeline_state_from_jax(variables: Tree) -> Dict[str, State]:
    """The JAX pipeline's ``params`` ({"clip", "brain", "prior", "head"},
    each a flax variables dict) -> ``AviTalkingPipeline.load_state_dict``
    input."""
    return {
        "clip": clip_text_state_from_jax(variables["clip"]["params"]),
        "brain": brain_state_from_jax(variables["brain"]["params"]),
        "prior": prior_state_from_jax(variables["prior"]["params"]),
        "head": emote_head_state_from_jax(variables["head"]),
    }


def _conv2d_any(p: Tree) -> State:
    """A flax Conv (kh, kw, in, out) or ConvTranspose with
    ``transpose_kernel`` (kh, kw, out, in) -> torch's (out, in, kh, kw) /
    (in, out, kh, kw): the same axis order either way."""
    out = {"weight": _a(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def _adain(p: Tree) -> State:
    return {**{f"mlp_shared.0.{k}": v for k, v in _dense(p["mlp_shared"]).items()},
            **{f"mlp_gamma.{k}": v for k, v in _dense(p["mlp_gamma"]).items()},
            **{f"mlp_beta.{k}": v for k, v in _dense(p["mlp_beta"]).items()}}


def _layernorm2d(p: Tree) -> State:
    return {"weight": _a(np.asarray(p["weight"]).reshape(-1, 1, 1)),
            "bias": _a(np.asarray(p["bias"]).reshape(-1, 1, 1))}


def pirender_state_from_jax(variables: Tree) -> State:
    """``models.pirender.FaceGenerator`` variables -> port state, under the
    reference ``net_G``'s names."""
    params = variables["params"] if "params" in variables else variables
    out: State = {}
    m = params["mapping_net"]
    _put(out, "mapping_net.first.0.", _conv(m["first"]))
    for i in range(_count(m, "encoder")):
        _put(out, f"mapping_net.encoder{i}.1.", _conv(m[f"encoder{i}"]))
    w = params["warpping_net"]
    hg, pre = w["hourglass"], "warpping_net.hourglass."
    _put(out, pre + "encoder.input_layer.", _conv2d_any(hg["input_layer"]))
    for name, blk in hg.items():
        if name.startswith("encoder"):
            sub = f"{pre}encoder.{name}."
        elif name.startswith("decoder"):
            sub = f"{pre}decoder.{name}."
        else:
            continue
        for part, p in blk.items():
            if part.startswith("norm"):
                _put(out, f"{sub}{part}.", _adain(p))
            else:
                _put(out, f"{sub}{part}.", _conv2d_any(p["conv"] if "conv" in p else p))
    _put(out, "warpping_net.flow_out.0.", _layernorm2d(w["flow_norm"]))
    _put(out, "warpping_net.flow_out.2.", _conv2d_any(w["flow_out"]))
    e = params["editing_net"]
    _put(out, "editing_net.encoder.first.model.0.", _conv2d_any(e["first_conv"]))
    _put(out, "editing_net.encoder.first.model.1.", _layernorm2d(e["first_norm"]))
    for name, p in e.items():
        stem, _, kind = name.partition("_")
        if stem.startswith("down"):
            sub = f"editing_net.encoder.{stem}.model."
        elif stem.startswith(("up", "jump")):
            sub = f"editing_net.decoder.{stem}.model."
        elif stem.startswith("res"):
            sub = f"editing_net.decoder.{stem}.res{kind}."
            for part, q in p.items():
                _put(out, f"{sub}{part}.", _adain(q) if part.startswith("norm")
                     else _conv2d_any(q))
            continue
        else:
            continue
        _put(out, sub + ("0." if kind == "conv" else "1."),
             _conv2d_any(p) if kind == "conv" else _layernorm2d(p))
    _put(out, "editing_net.decoder.final.model.0.", _conv2d_any(e["final_conv"]))
    return out


def _nlayer_state(params: Tree, spectral: Tree) -> State:
    out: State = {}
    _put(out, "model0.0.", _conv2d_any(params["conv0"]))
    n = 1
    while f"conv{n}" in params:
        pre = f"model{n}.0.0."
        conv = _conv2d_any(params[f"conv{n}"])
        if f"conv{n}" in spectral:
            out[pre + "weight_orig"] = conv.pop("weight")
            out[pre + "weight_u"] = _a(spectral[f"conv{n}"]["u"])
            out[pre + "weight_v"] = _a(spectral[f"conv{n}"]["v"])
        _put(out, pre, conv)
        n += 1
    _put(out, f"model{n}.0.", _conv2d_any(params["conv_out"]))
    return out


def discriminator_state_from_jax(variables: Tree) -> State:
    """``models.discriminator`` variables -> port state: a
    ``MultiscaleDiscriminator`` or ``NLayerDiscriminator`` (params and the
    ``spectral`` u, v), or an ``ImageDiscriminator`` (params and
    ``batch_stats``), under the reference's names."""
    params = variables["params"]
    if "bn1" in params:
        stats, out, idx, n = variables["batch_stats"], {}, 2, 1
        _put(out, "model.0.", _conv2d_any(params["conv0"]))
        while f"bn{n}" in params:
            _put(out, f"model.{idx}.", _conv2d_any(params[f"conv{n}"]))
            _put(out, f"model.{idx + 1}.", _batchnorm(params[f"bn{n}"], stats[f"bn{n}"]))
            idx, n = idx + 3, n + 1
        _put(out, f"model.{idx}.", _conv2d_any(params["conv_out"]))
        return out
    spectral = variables.get("spectral", {})
    if "discriminator_0" not in params:
        return _nlayer_state(params, spectral)
    out: State = {}
    for i in range(_count(params, "discriminator_")):
        name = f"discriminator_{i}"
        _put(out, name + ".", _nlayer_state(params[name], spectral.get(name, {})))
    return out


def vgg19_state_from_jax(params: Tree) -> State:
    """``train.perceptual.Vgg19Features`` params -> port state, under
    torchvision's ``features.N`` names."""
    params = params["params"] if "params" in params else params
    out: State = {}
    idx = 0
    for stage, n_convs in enumerate((2, 2, 4, 4, 4), start=1):
        for ci in range(1, n_convs + 1):
            _put(out, f"features.{idx}.", _conv2d_any(params[f"conv{stage}_{ci}"]))
            idx += 2
        idx += 1
    return out


def deca_encoder_state_from_jax(params: Tree, batch_stats: Tree) -> State:
    """``models.emoca.DecaEncoder`` params + batch_stats -> port state
    (``encoder.*``, ``layers.0`` / ``layers.2``)."""
    out: State = {}
    _put(out, "encoder.", resnet50_state_from_jax(params["encoder"], batch_stats["encoder"]))
    _put(out, "layers.0.", _dense(params["layers_0"]))
    _put(out, "layers.2.", _dense(params["layers_2"]))
    return out


def emoca_encoder_state_from_jax(variables: Tree) -> State:
    """``models.emoca.EmocaEncoder`` variables -> port state: JAX's towers
    ``coarse`` / ``expression`` / ``detail`` under the reference's
    ``E_flame.`` / ``E_expression.`` / ``E_detail.``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    for name, pre in (("coarse", "E_flame."), ("expression", "E_expression."),
                      ("detail", "E_detail.")):
        if name in params:
            _put(out, pre, deca_encoder_state_from_jax(params[name], stats[name]))
    return out


def detail_generator_state_from_jax(variables: Tree) -> State:
    """``models.deca_detail.DetailGenerator`` variables -> port state, under
    the reference Generator's names (``l1.0``, ``conv_blocks.N``: BatchNorm
    0, then per up-block i conv 2 + 4i and BatchNorm 3 + 4i, the last conv
    21)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "l1.0.", _dense(params["l1"]))
    _put(out, "conv_blocks.0.", _batchnorm(params["bn_in"], stats["bn_in"]))
    for i in range(5):
        _put(out, f"conv_blocks.{2 + 4 * i}.", _conv_nd(params[f"conv{i}"]))
        _put(out, f"conv_blocks.{3 + 4 * i}.", _batchnorm(params[f"bn{i}"], stats[f"bn{i}"]))
    _put(out, "conv_blocks.21.", _conv_nd(params["conv_out"]))
    return out


def _bn_wrapped(p: Tree, s: Tree, name: str) -> State:
    """A BatchNorm under flax's ``_BN`` wrapper (``{name: {"bn": ...}}``)."""
    return _batchnorm(p[name]["bn"], s[name]["bn"])


def fan_landmarks_state_from_jax(variables: Tree) -> State:
    """``models.fan_landmarks.FanLandmarkNet`` variables -> port state, under
    face_alignment's names."""
    p, s = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "conv1.", _conv_nd(p["conv1"]))
    _put(out, "bn1.", _bn_wrapped(p, s, "bn1"))
    for name in ("conv2", "conv3", "conv4"):
        _put(out, name + ".", _fan_convblock(p[name], s[name]))
    i = 0
    while f"m{i}" in p:
        for blk in p[f"m{i}"]:
            _put(out, f"m{i}.{blk}.", _fan_convblock(p[f"m{i}"][blk], s[f"m{i}"][blk]))
        _put(out, f"top_m_{i}.", _fan_convblock(p[f"top_m_{i}"], s[f"top_m_{i}"]))
        _put(out, f"bn_end{i}.", _bn_wrapped(p, s, f"bn_end{i}"))
        for name in (f"conv_last{i}", f"l{i}", f"bl{i}", f"al{i}"):
            if name in p:
                _put(out, name + ".", _conv_nd(p[name]))
        i += 1
    return out


def sfd_state_from_jax(variables: Tree) -> State:
    """``models.sfd.S3FD`` params -> port state (face_alignment's names; the
    L2Norm scales as they are)."""
    out: State = {}
    for name, p in variables["params"].items():
        if "kernel" in p:
            _put(out, name + ".", _conv_nd(p))
        else:
            out[name + ".weight"] = _a(p["weight"])
    return out


def _cbr(p: Tree, s: Tree) -> State:
    out = _conv_nd(p["conv"])
    return {"conv." + k: v for k, v in out.items()} | {
        "bn." + k: v for k, v in _bn_wrapped(p, s, "bn").items()}


def bisenet_state_from_jax(variables: Tree) -> State:
    """``models.bisenet.BiSeNet`` variables -> port state, under
    face-parsing.PyTorch's names (``cp.resnet.*``, ``cp.arm16``, ``ffm.*``,
    ``conv_out.*``)."""
    p, s = variables["params"], variables["batch_stats"]
    out: State = {}
    rp, rs = p["resnet"], s["resnet"]
    _put(out, "cp.resnet.conv1.", _conv_nd(rp["conv1"]))
    _put(out, "cp.resnet.bn1.", _bn_wrapped(rp, rs, "bn1"))
    for L in range(1, 5):
        for b in range(2):
            bp, bs, pre = rp[f"layer{L}_{b}"], rs[f"layer{L}_{b}"], f"cp.resnet.layer{L}.{b}."
            for c in ("1", "2"):
                _put(out, f"{pre}conv{c}.", _conv_nd(bp[f"conv{c}"]))
                _put(out, f"{pre}bn{c}.", _bn_wrapped(bp, bs, f"bn{c}"))
            if "down_conv" in bp:
                _put(out, pre + "downsample.0.", _conv_nd(bp["down_conv"]))
                _put(out, pre + "downsample.1.", _bn_wrapped(bp, bs, "down_bn"))
    for arm in ("arm16", "arm32"):
        _put(out, f"cp.{arm}.conv.", _cbr(p[arm]["conv"], s[arm]["conv"]))
        _put(out, f"cp.{arm}.conv_atten.", _conv_nd(p[arm]["conv_atten"]))
        _put(out, f"cp.{arm}.bn_atten.", _bn_wrapped(p[arm], s[arm], "bn_atten"))
    for head in ("conv_head16", "conv_head32", "conv_avg"):
        _put(out, f"cp.{head}.", _cbr(p[head], s[head]))
    _put(out, "ffm.convblk.", _cbr(p["ffm"]["convblk"], s["ffm"]["convblk"]))
    _put(out, "ffm.conv1.", _conv_nd(p["ffm"]["conv1"]))
    _put(out, "ffm.conv2.", _conv_nd(p["ffm"]["conv2"]))
    _put(out, "conv_out.conv.", _cbr(p["conv_out"]["conv"], s["conv_out"]["conv"]))
    _put(out, "conv_out.conv_out.", _conv_nd(p["conv_out"]["conv_out"]))
    return out


def resnet_se_state_from_jax(variables: Tree) -> State:
    """``models.resnet_se.ResNetSE`` variables -> port state, under the
    reference's names (``layer{l}.{b}.se.fc.0``, ``attention.0`` / ``.2`` /
    ``.3``)."""
    p, s = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "conv1.", _conv_nd(p["conv1"]))
    _put(out, "bn1.", _batchnorm(p["bn1"], s["bn1"]))
    li = 1
    while f"layer{li}_0" in p:
        bi = 0
        while f"layer{li}_{bi}" in p:
            bp, bs, pre = p[f"layer{li}_{bi}"], s[f"layer{li}_{bi}"], f"layer{li}.{bi}."
            for c in ("1", "2"):
                _put(out, f"{pre}conv{c}.", _conv_nd(bp[f"conv{c}"]))
                _put(out, f"{pre}bn{c}.", _batchnorm(bp[f"bn{c}"], bs[f"bn{c}"]))
            _put(out, pre + "se.fc.0.", _dense(bp["se"]["fc0"]))
            _put(out, pre + "se.fc.2.", _dense(bp["se"]["fc2"]))
            if "down_conv" in bp:
                _put(out, pre + "downsample.0.", _conv_nd(bp["down_conv"]))
                _put(out, pre + "downsample.1.", _batchnorm(bp["down_bn"], bs["down_bn"]))
            bi += 1
        li += 1
    _put(out, "attention.0.", _conv(p["att0"]))
    _put(out, "attention.2.", _batchnorm(p["att2"], s["att2"]))
    _put(out, "attention.3.", _conv(p["att3"]))
    _put(out, "fc.", _dense(p["fc"]))
    return out


def d3dfr_state_from_jax(variables: Tree) -> State:
    """``viz.bfm.D3dfrReconNet`` variables -> port state: ``backbone.*`` and
    the heads as 1x1 convs ``final_layers.{i}``."""
    p, s = variables["params"], variables["batch_stats"]
    out: State = {}
    _put(out, "backbone.", resnet50_state_from_jax(p["backbone"], s["backbone"]))
    i = 0
    while f"head{i}" in p:
        out[f"final_layers.{i}.weight"] = _a(np.asarray(p[f"head{i}"]["kernel"]).T[:, :, None, None])
        out[f"final_layers.{i}.bias"] = _a(p[f"head{i}"]["bias"])
        i += 1
    return out


def wav2vec2_ser_state_from_jax(params: Tree) -> State:
    """``audio.ser.Wav2Vec2SER`` params -> port state."""
    out: State = {}
    _put(out, "wav2vec2.", wav2vec2_state_from_jax(params["wav2vec2"]))
    _put(out, "projector.", _dense(params["projector"]))
    _put(out, "classifier.", _dense(params["classifier"]))
    return out
