"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the JAX parameter tree of ``lm_init`` (dense
or moe),
``zamba_init`` (hybrid) or ``xlstm_init`` (ssm) with every leaf as a numpy
array (``jax.tree_util.tree_map(np.asarray, p)``) and builds the port's
``TransformerLM``, ``ZambaLM`` or ``XLSTMLM``:

- a stacked leading axis (``blocks``, ``mblocks``, ``tail``, ``sblocks``)
  becomes one module per layer; the hybrid ``shared`` block is one
  ``Block``;
- dense ``kernel``s stay (d_in, d_out), the experts' stacked ``gate`` and
  ``up`` (E, d, f) and ``down`` (E, f, d), and the embedding ``table``
  stays (V, d), cast to the compute dtype (the reference casts at every
  use); the MoE router's kernel stays float32 (the reference casts it to
  fp32);
- norm ``scale``s, the mamba ``conv``, ``A_log``, ``D`` and ``dt_bias``,
  the mLSTM gate projection ``w_if`` and ``b_if`` and the sLSTM ``bias``
  stay float32 (the reference casts ``conv`` and ``bias`` at use).

``graph_params_from_numpy`` takes the reference's layer-graph parameters
(``repro.core.exec.layers.init_params``: layer name -> parameter name ->
array, leaves as numpy) and returns the same tree of float32 tensors, the
layout ``repro_torch.core.exec.layers`` uses.

``optim_state_from_numpy`` carries a reference ``OptimRuntime``'s host
state (``repro.core.optim_offload``: per layer the int8 blocks and fp32
scales, or the fp32 state when uncompressed, the EF residual and the step
count, leaves as numpy) into a port runtime built from the same plan, so
the port can continue a reference run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import (TransformerLM, XLSTMLM,
                                            xlstm_layout)
from repro_torch.models.zamba import ZambaLM, layout

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("gate", "up", "down")
_SSM_F32 = ("conv", "A_log", "D", "dt_bias")
# (dense kernels, float32 leaves) of the xLSTM blocks
_MLSTM = (("up_l", "up_r", "wq", "wk", "wv", "down"), ("w_if", "b_if"))
_SLSTM = (("wx", "wh", "proj"), ("bias",))


def graph_params_from_numpy(params, device: DeviceLike = None):
    """Layer-graph parameters (dict of dicts of arrays) as port tensors."""
    dev = resolve_device(device)
    return {layer: {n: torch.from_numpy(np.array(a, np.float32)).to(dev)
                    for n, a in entry.items()}
            for layer, entry in params.items()}


def optim_state_from_numpy(runtime, host_state, residual, count: int
                           ) -> None:
    """Write a reference runtime's host state into ``runtime`` (a
    ``repro_torch.core.optim_offload.OptimRuntime`` of the same plan), in
    place: its pinned host copies stay where they are."""
    for layer, hs in host_state.items():
        dst = runtime.host_state[layer]
        if isinstance(dst, dict):
            for part in ("q", "scale"):
                dst[part].copy_(torch.from_numpy(np.array(hs[part])))
            runtime.residual[layer].copy_(
                torch.from_numpy(np.array(residual[layer])))
        else:
            dst.copy_(torch.from_numpy(np.array(hs)))
    runtime.count = int(count)


def params_from_numpy(tree, cfg: ModelConfig,
                      device: DeviceLike = None) -> nn.Module:
    if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    dt = layers.dtype_of(cfg.dtype)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    def block(p, i=None):
        """One dense block; ``i`` picks a layer of a stacked tree."""
        def at(a):
            return a if i is None else a[i]
        out = {
            "ln1": t(at(p["ln1"]["scale"])),
            "attn": {n: t(at(p["attn"][n]["kernel"]), dt) for n in _ATTN},
            "ln2": t(at(p["ln2"]["scale"])),
        }
        if "moe" in p:
            out["moe"] = {"router": t(at(p["moe"]["router"]["kernel"])),
                          **{n: t(at(p["moe"][n]), dt) for n in _MLP}}
        else:
            out["mlp"] = {n: t(at(p["mlp"][n]["kernel"]), dt) for n in _MLP}
        return out

    def mamba(p, i):
        s = p["ssm"]
        return {"ln": t(p["ln"]["scale"][i]), "ssm": {
            "in_proj": t(s["in_proj"]["kernel"][i], dt),
            **{n: t(s[n][i]) for n in _SSM_F32},
            "norm": t(s["norm"]["scale"][i]),
            "out_proj": t(s["out_proj"]["kernel"][i], dt),
        }}

    port = {"embed": t(tree["embed"]["table"], dt),
            "ln_f": t(tree["ln_f"]["scale"])}
    if "unembed" in tree:
        port["unembed"] = t(tree["unembed"]["kernel"], dt)
    if cfg.family in ("dense", "moe"):
        port["blocks"] = [block(tree["blocks"], i)
                          for i in range(cfg.n_layers)]
        return TransformerLM(cfg, port)
    if cfg.family == "ssm":
        def xblock(p, kind, names, i):
            """Layer ``i`` of a stacked mLSTM or sLSTM tree."""
            s, (dense, f32) = p[kind], names
            return {"ln": t(p["ln"]["scale"][i]), kind: {
                **{n: t(s[n]["kernel"][i], dt) for n in dense},
                **{n: t(s[n][i]) for n in f32},
                "norm": t(s["norm"]["scale"][i]),
            }}

        n_groups, per = xlstm_layout(cfg)
        port["mblocks"] = [xblock(tree["mblocks"], "mlstm", _MLSTM, i)
                           for i in range(n_groups * per)]
        port["sblocks"] = [xblock(tree["sblocks"], "slstm", _SLSTM, i)
                           for i in range(n_groups)]
        return XLSTMLM(cfg, port)
    n_groups, tail = layout(cfg)
    port["mblocks"] = [mamba(tree["mblocks"], i)
                       for i in range(n_groups * cfg.shared_attn_every)]
    port["tail"] = [mamba(tree["tail"], i) for i in range(tail)]
    port["shared"] = block(tree["shared"])
    return ZambaLM(cfg, port)
