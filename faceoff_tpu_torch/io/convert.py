"""Weight bridge between the JAX package's variables and the port.

`from_jax_variables(params, vq)` takes `variables["params"]` and
`variables["vq"]` of a `faceoff_tpu` VQVAE as nested dicts of numpy
arrays (codebooks as any object or dict with `embed`, `cluster_size` and
`embed_avg`) and returns the state_dict that `models.vqvae.VQVAE` loads
with `strict=True`. `to_jax_variables(state_dict)` goes the other way,
EMA codebook state included, so that a JAX `TrainState`'s params/vq and
the port's model can be made to hold the same numbers in either
direction. `lpips_from_jax_variables(params)` does the same for
`models.lpips.LPIPS`, and `discriminator_from_jax_variables(variables,
module)` / `discriminator_to_jax_variables(state_dict, module)` for the
discriminators of `models.discriminators` (params and, where there is
BatchNorm, `batch_stats`). `b2f_from_jax_variables` /
`b2f_to_jax_variables` carry `models.vqvae_b2f.VQVAE_B2F` (its six
codebooks included), `alignment_from_jax_variables` /
`alignment_to_jax_variables` `models.alignment.AlignmentNet`, and
`contrastive_from_jax_variables` / `contrastive_to_jax_variables`
`losses.contrastive.SiameseFaceEmbedder` (params and `batch_stats`).
Layout transforms:

  Conv2d          HWIO        -> OIHW           transpose(3, 2, 0, 1)
  Conv3d          DHWIO       -> OIDHW          transpose(4, 3, 0, 1, 2)
  Dense           (in, out)   -> (out, in)      transpose
  ConvTranspose2d (kH,kW,I,O) -> (I,O,kH,kW)    spatial flip, then
                                                transpose(2, 3, 0, 1)
  codebooks       (dim, n_embed) buffers, unchanged
  BatchNorm       scale, bias, mean, var -> weight, bias, running_mean,
                  running_var
  ActNorm         loc, scale, unchanged

Flax's ConvTranspose does not flip its kernel; torch's ConvTranspose2d is
the gradient of a convolution, which does, hence the flip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from faceoff_tpu_torch.models import discriminators as D
from faceoff_tpu_torch.models.lpips import state_dict_from_arrays

_CONV2D, _CONV3D, _CONVT2D = "conv2d", "conv3d", "convT2d"


def _encoder_entries(name: str, stride: int, n_res_block: int) -> List:
    if stride == 4:
        seq, base = [(0, "Conv_0"), (2, "Conv_1"), (4, "Conv_2")], 5
    else:
        seq, base = [(0, "Conv_0"), (2, "Conv_1")], 3
    out = [(f"{name}.blocks.{i}", (name, fl), _CONV2D) for i, fl in seq]
    for r in range(n_res_block):
        out.append((f"{name}.blocks.{base + r}.conv.1",
                    (name, f"ResBlock_{r}", "Conv_0"), _CONV2D))
        out.append((f"{name}.blocks.{base + r}.conv.3",
                    (name, f"ResBlock_{r}", "Conv_1"), _CONV2D))
    return out


def _decoder_entries(name: str, stride: int, n_res_block: int) -> List:
    out = [(f"{name}.blocks.0", (name, "Conv_0"), _CONV2D)]
    for r in range(n_res_block):
        out.append((f"{name}.blocks.{1 + r}.conv.1",
                    (name, f"ResBlock_{r}", "Conv_0"), _CONV2D))
        out.append((f"{name}.blocks.{1 + r}.conv.3",
                    (name, f"ResBlock_{r}", "Conv_1"), _CONV2D))
    ct = n_res_block + 2  # Conv, the res blocks, ReLU, then the transposes
    out.append((f"{name}.blocks.{ct}", (name, "ConvTranspose_0"), _CONVT2D))
    if stride == 4:
        out.append(
            (f"{name}.blocks.{ct + 2}", (name, "ConvTranspose_1"), _CONVT2D)
        )
    return out


def _postnet_entries(torch_name: str, flax_name: str, n_layers: int) -> List:
    return [(f"{torch_name}.conv3d.{j}.0", (flax_name, f"Conv_{j}"), _CONV3D)
            for j in range(n_layers)]


def layer_map(n_res_block: int, n_postnet_layers: int) -> List[Tuple[str, tuple, str]]:
    """(torch prefix, flax params path, kind) for every conv of the VQVAE."""
    entries = []
    entries += _encoder_entries("enc_b", 4, n_res_block)
    entries += _encoder_entries("enc_t", 2, n_res_block)
    entries += [("quantize_conv_t", ("quantize_conv_t",), _CONV2D),
                ("quantize_conv_b", ("quantize_conv_b",), _CONV2D)]
    entries += _decoder_entries("dec_t", 2, n_res_block)
    entries += [("upsample_t", ("upsample_t",), _CONVT2D)]
    entries += _decoder_entries("dec", 4, n_res_block)
    entries += _postnet_entries("conv3d_encoded_b", "postnet_b", n_postnet_layers)
    entries += _postnet_entries("conv3d_encoded_t", "postnet_t", n_postnet_layers)
    return entries


def _to_torch(k: np.ndarray, kind: str) -> np.ndarray:
    if kind == _CONV2D:
        return np.transpose(k, (3, 2, 0, 1))
    if kind == _CONV3D:
        return np.transpose(k, (4, 3, 0, 1, 2))
    if kind == _CONVT2D:
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    raise ValueError(kind)


def _from_torch(k: np.ndarray, kind: str) -> np.ndarray:
    if kind == _CONV2D:
        return np.transpose(k, (2, 3, 1, 0))
    if kind == _CONV3D:
        return np.transpose(k, (2, 3, 4, 1, 0))
    if kind == _CONVT2D:
        return np.transpose(k, (2, 3, 0, 1))[::-1, ::-1]
    raise ValueError(kind)


def _count(tree: Mapping, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _field(codebook: Any, name: str) -> np.ndarray:
    if isinstance(codebook, Mapping):
        return np.asarray(codebook[name])
    return np.asarray(getattr(codebook, name))


def _walk(tree: Mapping, path: tuple) -> Mapping:
    for p in path:
        tree = tree[p]
    return tree


_DENSE = "dense"


def _layer_to_torch(node: Mapping, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    k = np.asarray(node["kernel"], np.float32)
    k = k.T if kind == _DENSE else _to_torch(k, kind)
    return np.array(k, order="C"), np.array(node["bias"], np.float32)


def _layer_from_torch(w: np.ndarray, kind: str) -> np.ndarray:
    return np.ascontiguousarray(w.T if kind == _DENSE
                                else _from_torch(w, kind))


def _sd_from_params(params: Mapping, entries: List) -> Dict[str, torch.Tensor]:
    sd = {}
    for t_name, f_path, kind in entries:
        w, b = _layer_to_torch(_walk(params, f_path), kind)
        sd[f"{t_name}.weight"] = torch.from_numpy(w)
        sd[f"{t_name}.bias"] = torch.from_numpy(b)
    return sd


def _params_from_sd(sd: Mapping[str, np.ndarray], entries: List) -> Dict:
    params: Dict[str, Any] = {}
    for t_name, f_path, kind in entries:
        node = params
        for p in f_path:
            node = node.setdefault(p, {})
        node["kernel"] = _layer_from_torch(sd[f"{t_name}.weight"], kind)
        node["bias"] = sd[f"{t_name}.bias"]
    return params


def _numpy_sd(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in state_dict.items()}


def from_jax_variables(params: Mapping, vq: Mapping) -> Dict[str, torch.Tensor]:
    """JAX VQVAE variables -> the port's VQVAE state_dict (float32, CPU).

    The number of res blocks and postnet layers is read from `params`.
    """
    n_res_block = _count(params["enc_b"], "ResBlock_")
    n_post = _count(params["postnet_b"], "Conv_")
    sd = _sd_from_params(params, layer_map(n_res_block, n_post))
    for level in ("quantize_t", "quantize_b"):
        cb = vq[level]["codebook"]
        for name in ("embed", "cluster_size", "embed_avg"):
            sd[f"{level}.{name}"] = torch.from_numpy(
                np.array(_field(cb, name), np.float32)
            )
    return sd


_LEVELS = ("quantize_t", "quantize_b")
_CODEBOOK = ("embed", "cluster_size", "embed_avg")


def to_jax_variables(
    state_dict: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's VQVAE state_dict -> (params, vq) as nested dicts of
    float32 numpy arrays in the JAX package's layout; vq maps each level
    to {"codebook": {"embed", "cluster_size", "embed_avg"}}, the fields of
    the JAX package's `VQCodebook`."""
    sd = _numpy_sd(state_dict)
    n_res_block = len({k.split(".")[2] for k in sd
                       if k.startswith("enc_b.blocks.") and ".conv." in k})
    n_post = len({k.split(".")[2] for k in sd
                  if k.startswith("conv3d_encoded_b.conv3d.")})
    params = _params_from_sd(sd, layer_map(n_res_block, n_post))
    vq = {level: {"codebook": {name: sd[f"{level}.{name}"]
                               for name in _CODEBOOK}}
          for level in _LEVELS}
    return params, vq


def lpips_from_jax_variables(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LPIPS `variables["params"]` (`vgg/convB_C`, `linK`) -> the
    state_dict entries of `models.lpips.LPIPS` (its weights; the input
    standardisation buffers are constants)."""
    arrays = {}
    for name, node in params["vgg"].items():
        arrays[f"vgg/{name}/kernel"] = node["kernel"]
        arrays[f"vgg/{name}/bias"] = node["bias"]
    for name, node in params.items():
        if name.startswith("lin"):
            arrays[f"{name}/kernel"] = node["kernel"]
    return state_dict_from_arrays(arrays)


def _disc_stacks(module: nn.Module) -> List[Tuple[str, tuple, nn.Module]]:
    """(state_dict prefix, Flax path, module holding `convs` and `norms`)
    for each conv stack of a discriminator."""
    if isinstance(module, D._Multiscale):
        return [(f"scales.{i}.", (f"scale{module.num_D - 1 - i}",), s)
                for i, s in enumerate(module.scales)]
    return [("", (), module)]


def _norm_entries(norm: nn.Module, j: int) -> List[Tuple[str, str, str, str]]:
    """(Flax module, collection, Flax name, torch name) of norm j."""
    if isinstance(norm, D.BatchNorm):
        f = f"BatchNorm_{j}"
        return [(f, "params", "scale", "weight"), (f, "params", "bias", "bias"),
                (f, "batch_stats", "mean", "running_mean"),
                (f, "batch_stats", "var", "running_var")]
    if isinstance(norm, D.ActNorm):
        f = f"ActNorm_{j}"
        return [(f, "params", "loc", "loc"), (f, "params", "scale", "scale")]
    return []  # InstanceNorm: nothing to carry


def discriminator_from_jax_variables(
    variables: Mapping, module: nn.Module,
) -> Dict[str, torch.Tensor]:
    """A Flax discriminator's `variables` ({"params"[, "batch_stats"]}, nested
    dicts of arrays) -> the state_dict of `module`, the port's
    discriminator of the same class and widths (float32, CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, stack in _disc_stacks(module):
        trees = {c: _walk(variables[c], path) for c in ("params",
                                                         "batch_stats")
                 if c in variables}
        for j, conv in enumerate(stack.convs):
            node = trees["params"][f"Conv_{j}"]
            kind = _CONV2D if isinstance(conv, nn.Conv2d) else _CONV3D
            kernel = _to_torch(np.asarray(node["kernel"], np.float32), kind)
            sd[f"{prefix}convs.{j}.weight"] = torch.from_numpy(
                np.array(kernel, order="C"))
            if conv.bias is not None:
                sd[f"{prefix}convs.{j}.bias"] = torch.from_numpy(
                    np.array(node["bias"], np.float32))
        for j, norm in enumerate(stack.norms):
            for fmod, coll, fname, tname in _norm_entries(norm, j):
                sd[f"{prefix}norms.{j}.{tname}"] = torch.from_numpy(
                    np.array(trees[coll][fmod][fname], np.float32))
    return sd


def discriminator_to_jax_variables(
    state_dict: Mapping[str, torch.Tensor], module: nn.Module,
) -> Dict[str, Any]:
    """The port's discriminator state_dict -> Flax variables
    {"params"[, "batch_stats"]} of float32 numpy arrays."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in state_dict.items()}
    out: Dict[str, Any] = {"params": {}}
    for prefix, path, stack in _disc_stacks(module):
        def node(coll, *names):
            tree = out.setdefault(coll, {})
            for p in path + names:
                tree = tree.setdefault(p, {})
            return tree

        for j, conv in enumerate(stack.convs):
            kind = _CONV2D if isinstance(conv, nn.Conv2d) else _CONV3D
            n = node("params", f"Conv_{j}")
            n["kernel"] = np.ascontiguousarray(
                _from_torch(sd[f"{prefix}convs.{j}.weight"], kind))
            if conv.bias is not None:
                n["bias"] = sd[f"{prefix}convs.{j}.bias"]
        for j, norm in enumerate(stack.norms):
            for fmod, coll, fname, tname in _norm_entries(norm, j):
                node(coll, fmod)[fname] = sd[f"{prefix}norms.{j}.{tname}"]
    return out


_B2F_TOWERS = ("encode_face", "encode_rhand", "encode_lhand")


def b2f_layer_map(n_res_block: int) -> List[Tuple[str, tuple, str]]:
    """(torch prefix, flax params path, kind) for every conv of VQVAE_B2F."""
    entries = []
    for tower in _B2F_TOWERS:
        inner = (_encoder_entries("enc_b", 4, n_res_block)
                 + _encoder_entries("enc_t", 2, n_res_block)
                 + [("quantize_conv_t", ("quantize_conv_t",), _CONV2D),
                    ("quantize_conv_b", ("quantize_conv_b",), _CONV2D)]
                 + _decoder_entries("dec_t", 2, n_res_block))
        entries += [(f"{tower}.{t}", (tower,) + f, k) for t, f, k in inner]
    entries.append(("upsample_t", ("upsample_t",), _CONVT2D))
    entries += _decoder_entries("dec", 4, n_res_block)
    return entries


def b2f_from_jax_variables(params: Mapping, vq: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """JAX VQVAE_B2F variables (`params`, `vq`) -> the port's state_dict
    (float32, CPU)."""
    n_res_block = _count(params["encode_face"]["enc_b"], "ResBlock_")
    sd = _sd_from_params(params, b2f_layer_map(n_res_block))
    for tower in _B2F_TOWERS:
        for level in _LEVELS:
            cb = vq[tower][level]["codebook"]
            for name in _CODEBOOK:
                sd[f"{tower}.{level}.{name}"] = torch.from_numpy(
                    np.array(_field(cb, name), np.float32))
    return sd


def b2f_to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's VQVAE_B2F state_dict -> (params, vq) of float32 numpy
    arrays in the JAX layout (vq: tower -> level -> {"codebook": {embed,
    cluster_size, embed_avg}})."""
    sd = _numpy_sd(state_dict)
    n_res_block = len({k.split(".")[3] for k in sd
                       if k.startswith("encode_face.enc_b.blocks.")
                       and ".conv." in k})
    params = _params_from_sd(sd, b2f_layer_map(n_res_block))
    vq = {tower: {level: {"codebook": {name: sd[f"{tower}.{level}.{name}"]
                                       for name in _CODEBOOK}}
                  for level in _LEVELS}
          for tower in _B2F_TOWERS}
    return params, vq


def _alignment_entries(n_convs: int) -> List[Tuple[str, tuple, str]]:
    return ([(f"convs.{j}", (f"Conv_{j}",), _CONV2D) for j in range(n_convs)]
            + [(f"dense.{j}", (f"Dense_{j}",), _DENSE) for j in range(2)])


def alignment_from_jax_variables(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX AlignmentNet `variables["params"]` -> the port's state_dict."""
    return _sd_from_params(params, _alignment_entries(_count(params, "Conv_")))


def alignment_to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, Any]:
    """The port's AlignmentNet state_dict -> JAX `params`."""
    sd = _numpy_sd(state_dict)
    n = len({k.split(".")[1] for k in sd if k.startswith("convs.")})
    return _params_from_sd(sd, _alignment_entries(n))


_TOWER = "_FaceTower_0"


def _contrastive_entries(n_convs: int) -> List[Tuple[str, tuple, str]]:
    return ([(f"tower.convs.{j}", (_TOWER, f"Conv_{j}"), _CONV2D)
             for j in range(n_convs)]
            + [(f"tower.dense.{j}", (_TOWER, f"Dense_{j}"), _DENSE)
               for j in range(3)])


_BN_FIELDS = (("params", "scale", "weight"), ("params", "bias", "bias"),
              ("batch_stats", "mean", "running_mean"),
              ("batch_stats", "var", "running_var"))


def contrastive_from_jax_variables(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """JAX SiameseFaceEmbedder `variables` ({"params", "batch_stats"}) ->
    the port's state_dict. Both towers flatten in NHWC order, so the first
    Dense kernel needs no permutation."""
    n = _count(variables["params"][_TOWER], "Conv_")
    sd = _sd_from_params(variables["params"], _contrastive_entries(n))
    for j in range(n):
        for coll, fname, tname in _BN_FIELDS:
            sd[f"tower.norms.{j}.{tname}"] = torch.from_numpy(np.array(
                variables[coll][_TOWER][f"BatchNorm_{j}"][fname], np.float32))
    return sd


def contrastive_to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, Any]:
    """The port's SiameseFaceEmbedder state_dict -> JAX {"params",
    "batch_stats"}."""
    sd = _numpy_sd(state_dict)
    n = len({k.split(".")[2] for k in sd if k.startswith("tower.convs.")})
    out = {"params": _params_from_sd(sd, _contrastive_entries(n)),
           "batch_stats": {}}
    for j in range(n):
        for coll, fname, tname in _BN_FIELDS:
            out[coll].setdefault(_TOWER, {}).setdefault(
                f"BatchNorm_{j}", {})[fname] = sd[f"tower.norms.{j}.{tname}"]
    return out
