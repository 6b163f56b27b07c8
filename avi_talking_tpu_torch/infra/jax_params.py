"""Carry weights from the JAX package to the port.

Takes flax parameter trees as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, pipeline.params)``) and returns ``state_dict``s of
the port's modules as numpy arrays. Layout maps:

* Dense kernel (in, out) -> Linear weight (out, in);
* Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
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


def wav2vec2_state_from_jax(params: Tree) -> State:
    """``audio.wav2vec2.Wav2Vec2Model`` params -> port (HF-named) state."""
    out: State = {}
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


def emote_head_state_from_jax(variables: Tree) -> State:
    """``models.emote.EmoteTalkingHead`` variables ({"params",
    "batch_stats"}) -> port state. The style encoder is carried when the JAX
    tree has it (it does only if the JAX head ever ran it)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: State = {}
    _put(out, "audio_encoder.", wav2vec2_state_from_jax(params["audio_encoder"]))
    _put(out, "sequence_encoder.", _dense(params["sequence_encoder"]))
    if "style_encoder" in params:
        _put(out, "style_encoder.map.", _dense(params["style_encoder"]["map"]))
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
