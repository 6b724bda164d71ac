"""Carry the reference's dense-LM parameters into the port.

``params_from_numpy`` takes the JAX parameter tree of ``lm_init`` with
every leaf as a numpy array (``jax.tree_util.tree_map(np.asarray, p)``)
and builds the port's ``TransformerLM``:

- the stacked ``blocks`` leading axis becomes one ``Block`` per layer;
- dense ``kernel``s stay (d_in, d_out) and the embedding ``table`` stays
  (V, d), cast to the compute dtype (the reference casts at every use);
- norm ``scale``s stay float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import TransformerLM

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("gate", "up", "down")


def params_from_numpy(tree, cfg: ModelConfig,
                      device: DeviceLike = None) -> TransformerLM:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    dt = layers.dtype_of(cfg.dtype)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    blocks = tree["blocks"]
    port = {
        "embed": t(tree["embed"]["table"], dt),
        "blocks": [{
            "ln1": t(blocks["ln1"]["scale"][i], torch.float32),
            "attn": {n: t(blocks["attn"][n]["kernel"][i], dt) for n in _ATTN},
            "ln2": t(blocks["ln2"]["scale"][i], torch.float32),
            "mlp": {n: t(blocks["mlp"][n]["kernel"][i], dt) for n in _MLP},
        } for i in range(cfg.n_layers)],
        "ln_f": t(tree["ln_f"]["scale"], torch.float32),
    }
    if "unembed" in tree:
        port["unembed"] = t(tree["unembed"]["kernel"], dt)
    return TransformerLM(cfg, port)
