"""AdaFace IR-backbone checkpoint names -> the port's state dict.

Port of `jabd_tpu/recognition/torch_convert.py`: the pretrained AdaFace
checkpoints that the reference's evaluations load (validate_tinyface.py /
validate_IJB_S.py `--ckpt_path`) name their tensors after the reference's
net.py; `convert_ir_state_dict` is the JAX package's walk to flax trees,
copied, and `ir_state_dict_from_pth` composes it with
`utils/convert.state_dict_from_flax` (as `utils/torch_convert.py` does for
the detector), so reference name -> port name is the walk the JAX package
runs.

torch naming (net.py): input_layer.{0 conv,1 bn,2 prelu};
body.{n}.res_layer.{0 bn,1 conv,2 bn,3 prelu,4 conv,5 bn[,se_block]} with
shortcut_layer.{0 conv,1 bn} when channels change (BasicBlockIR :140-163;
BottleneckIR :166-194 has 9 res_layer entries);
output_layer.{0 bn2d,3 linear,4 bn1d(affine=False)}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from jabd_tpu_torch.recognition.net import IR_STAGES
from jabd_tpu_torch.utils.convert import state_dict_from_flax


def _conv_w(w):
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _bn(params, stats, sd, t, f):
    _set(params, f + ("scale",), sd[t + ".weight"])
    _set(params, f + ("bias",), sd[t + ".bias"])
    _set(stats, f + ("mean",), sd[t + ".running_mean"])
    _set(stats, f + ("var",), sd[t + ".running_var"])


def convert_ir_state_dict(
    sd: Dict[str, np.ndarray], num_layers: int = 50, mode: str = "ir"
) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats) for IRBackbone(num_layers, mode)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}

    _set(params, ("input_conv", "kernel"), _conv_w(sd["input_layer.0.weight"]))
    _bn(params, stats, sd, "input_layer.1", ("input_bn",))
    _set(params, ("input_prelu", "alpha"), sd["input_layer.2.weight"])

    bottleneck = num_layers > 100
    n = 0
    for si, (depth, units) in enumerate(IR_STAGES[num_layers]):
        for bi in range(units):
            t = f"body.{n}"
            f = (f"stage{si + 1}_block{bi}",)
            if not bottleneck:
                _bn(params, stats, sd, f"{t}.res_layer.0", f + ("bn0",))
                _set(params, f + ("conv1", "kernel"),
                     _conv_w(sd[f"{t}.res_layer.1.weight"]))
                _bn(params, stats, sd, f"{t}.res_layer.2", f + ("bn1",))
                _set(params, f + ("prelu", "alpha"),
                     sd[f"{t}.res_layer.3.weight"])
                _set(params, f + ("conv2", "kernel"),
                     _conv_w(sd[f"{t}.res_layer.4.weight"]))
                _bn(params, stats, sd, f"{t}.res_layer.5", f + ("bn2",))
                se_prefix = f"{t}.res_layer.se_block"
            else:
                _bn(params, stats, sd, f"{t}.res_layer.0", f + ("bn0",))
                _set(params, f + ("conv1", "kernel"),
                     _conv_w(sd[f"{t}.res_layer.1.weight"]))
                _bn(params, stats, sd, f"{t}.res_layer.2", f + ("bn1",))
                _set(params, f + ("prelu1", "alpha"),
                     sd[f"{t}.res_layer.3.weight"])
                _set(params, f + ("conv2", "kernel"),
                     _conv_w(sd[f"{t}.res_layer.4.weight"]))
                _bn(params, stats, sd, f"{t}.res_layer.5", f + ("bn2",))
                _set(params, f + ("prelu2", "alpha"),
                     sd[f"{t}.res_layer.6.weight"])
                _set(params, f + ("conv3", "kernel"),
                     _conv_w(sd[f"{t}.res_layer.7.weight"]))
                _bn(params, stats, sd, f"{t}.res_layer.8", f + ("bn3",))
                se_prefix = f"{t}.res_layer.se_block"
            if mode == "ir_se":
                _set(params, f + ("se", "fc1", "kernel"),
                     _conv_w(sd[f"{se_prefix}.fc1.weight"]))
                _set(params, f + ("se", "fc2", "kernel"),
                     _conv_w(sd[f"{se_prefix}.fc2.weight"]))
            if f"{t}.shortcut_layer.0.weight" in sd:
                _set(params, f + ("shortcut_conv", "kernel"),
                     _conv_w(sd[f"{t}.shortcut_layer.0.weight"]))
                _bn(params, stats, sd, f"{t}.shortcut_layer.1",
                    f + ("shortcut_bn",))
            n += 1

    _bn(params, stats, sd, "output_layer.0", ("output_bn",))
    _set(params, ("fc", "kernel"),
         np.transpose(sd["output_layer.3.weight"], (1, 0)))
    _set(params, ("fc", "bias"), sd["output_layer.3.bias"])
    # BatchNorm1d(512, affine=False): running stats only.
    _set(stats, ("features_bn", "mean"), sd["output_layer.4.running_mean"])
    _set(stats, ("features_bn", "var"), sd["output_layer.4.running_var"])
    return params, stats


def ir_state_dict_from_pth(sd: Dict, num_layers: int = 50, mode: str = "ir") -> Dict[str, torch.Tensor]:
    """A reference IR state dict (numpy or tensor values, e.g. from
    `utils/torch_convert.load_pth`) -> the port's IRBackbone state dict."""
    params, stats = convert_ir_state_dict(sd, num_layers, mode)
    return state_dict_from_flax({"params": params, "batch_stats": stats})
