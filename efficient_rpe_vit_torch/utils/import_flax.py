"""Load the JAX package's flax variables into the port's ViT.

`params`, `constants` and `state` are the JAX model's variable collections
as nested dicts of arrays (numpy arrays, or anything `numpy.asarray`
takes). Dense kernels [in, out] become Linear weights [out, in], LayerNorm
`scale` becomes `weight`, Omega is copied from `constants`, never redrawn,
and the feature-redraw counters come from `state`. A soft-MoE block's
`mlp` carries `router` (a Dense) and the expert tensors `w1`, `b1`, `w2`,
`b2`, copied as they are (the port keeps the flax layouts). The names produced are
the reference torch naming that
`efficient_rpe_vit_tpu.utils.import_torch.state_dict_to_params` maps back.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def moe_mlp_state_dict(p: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax MoeMlp's params -> the port MoeMlp's state dict (names under
    `prefix`): the router kernel transposed, the expert tensors as they are."""
    sd = {f"{prefix}router.weight": _tensor(p["router"]["kernel"]).T.contiguous(),
          f"{prefix}router.bias": _tensor(p["router"]["bias"])}
    for name in ("w1", "b1", "w2", "b2"):
        sd[prefix + name] = _tensor(p[name])
    return sd


def flax_to_state_dict(params: Mapping[str, Any],
                       constants: Optional[Mapping[str, Any]] = None,
                       state: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax (params, constants, state) -> reference-named torch state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix: str, p: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _tensor(p["kernel"]).T.contiguous()
        if "bias" in p:
            sd[f"{prefix}.bias"] = _tensor(p["bias"])

    def norm(prefix: str, p: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _tensor(p["scale"])
        sd[f"{prefix}.bias"] = _tensor(p["bias"])

    dense("patch_embedding", params["patch_embedding"])
    sd["cls_token"] = _tensor(params["cls_token"])
    sd["pos_embedding"] = _tensor(params["pos_embedding"])
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        pre = f"transformer_blocks.{i}."
        norm(pre + "norm1", blk["norm1"])
        norm(pre + "norm2", blk["norm2"])
        dense(pre + "attention.qkv", blk["attention"]["qkv"])
        dense(pre + "attention.proj", blk["attention"]["proj"])
        if "router" in blk["mlp"]:  # MoeMlp
            sd.update(moe_mlp_state_dict(blk["mlp"], pre + "mlp."))
        else:
            dense(pre + "mlp.0", blk["mlp"]["fc1"])
            dense(pre + "mlp.3", blk["mlp"]["fc2"])
        for name in ("rel_pos_bias", "circulant_coeffs"):  # KERPLE, Circulant-STRING
            if name in blk.get("rpe", {}):
                sd[pre + "rpe." + name] = _tensor(blk["rpe"][name])
        if constants is not None and f"block_{i}" in constants:
            sd[pre + "attention.omega"] = _tensor(
                constants[f"block_{i}"]["attention"]["omega"])
        if state is not None and f"block_{i}" in state:
            sd[pre + "attention.redraw_counter"] = torch.from_numpy(np.array(
                state[f"block_{i}"]["attention"]["redraw_counter"],
                dtype=np.int32))
        i += 1
    norm("mlp_head.0", params["head_norm"])
    dense("mlp_head.1", params["head"])
    return sd


def load_flax_variables(model: nn.Module, params: Mapping[str, Any],
                        constants: Optional[Mapping[str, Any]] = None,
                        state: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Copy flax variables into `model` (strict: every parameter, Omega
    buffer and redraw counter must be covered, with matching shapes).
    Returns the model."""
    model.load_state_dict(flax_to_state_dict(params, constants, state),
                          strict=True)
    return model
