"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the JAX parameter tree of ``lm_init`` (dense
or moe), ``zamba_init`` (hybrid), ``xlstm_init`` (ssm), ``encdec_init``
(audio) or ``vlm_init`` (vlm) with every leaf as a numpy array
(``jax.tree_util.tree_map(np.asarray, p)``) and builds the port's
``TransformerLM``, ``ZambaLM``, ``XLSTMLM``, ``EncDecLM`` or ``VisionLM``:

- a stacked leading axis (``blocks``, ``mblocks``, ``tail``, ``sblocks``,
  ``enc_blocks``, ``dec_blocks``, ``self_blocks``, ``cross_blocks``)
  becomes one module per layer; the hybrid ``shared`` block is one
  ``Block``; a cross block also carries ``ln_x``, ``xattn`` and
  ``xgate``;
- dense ``kernel``s stay (d_in, d_out), the experts' stacked ``gate`` and
  ``up`` (E, d, f) and ``down`` (E, f, d), and the embedding ``table``
  stays (V, d), cast to the compute dtype (the reference casts at every
  use); the MoE router's kernel stays float32 (the reference casts it to
  fp32);
- norm ``scale``s, the mamba ``conv``, ``A_log``, ``D`` and ``dt_bias``,
  the mLSTM gate projection ``w_if`` and ``b_if``, the sLSTM ``bias`` and
  the cross-attention gate ``xgate`` stay float32 (the reference casts
  ``conv`` and ``bias`` at use).

``graph_params_from_numpy`` takes the reference's layer-graph parameters
(``repro.core.exec.layers.init_params``: layer name -> parameter name ->
array, leaves as numpy) and returns the same tree of float32 tensors, the
layout ``repro_torch.core.exec.layers`` uses.

``adamw_state_from_numpy`` turns the reference's AdamW state for an LM
(``optimizer.init`` / ``update`` of ``repro.optim.adamw``: per parameter
leaf ``{"m", "v"}`` in fp32, bf16 or int8 ``{"q", "scale"}`` blocks, and
``count``) into the port's state over the same model's
``named_parameters()``, so the two can continue from one state.

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
from repro_torch.optim.optimizers import QBLOCK
from repro_torch.models.layers import weight_dtype
from repro_torch.models.multimodal import EncDecLM, VisionLM, vlm_layout
from repro_torch.models.transformer import (TransformerLM, XLSTMLM,
                                            padded_vocab, xlstm_counts)
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


def params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None,
                      *, trainable: bool = False,
                      shardings=None) -> nn.Module:
    """The port's model holding ``tree``'s values; ``trainable=True`` holds
    every leaf in float32 with gradients.  With ``shardings`` (parameter
    name -> placement on a mesh, a step bundle's ``in_shardings[0]``)
    each parameter holds this rank's block of the global value."""
    model = _params_from_numpy(tree, cfg, device, trainable=trainable)
    if shardings is not None:
        from repro_torch.sharding.api import shard_module
        shard_module(model, shardings)
    return model


def _params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike, *,
                       trainable: bool) -> nn.Module:
    dev = resolve_device(device)
    dt = weight_dtype(cfg, trainable)

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
        if "xattn" in p:
            out["ln_x"] = t(at(p["ln_x"]["scale"]))
            out["xattn"] = {n: t(at(p["xattn"][n]["kernel"]), dt)
                            for n in _ATTN}
            out["xgate"] = t(at(p["xgate"]))
        return out

    def stack(root, n):
        return [block(tree[root], i) for i in range(n)]

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
        port["blocks"] = stack("blocks", cfg.n_layers)
        return TransformerLM(cfg, port, trainable=trainable)
    if cfg.family == "audio":
        port["enc_blocks"] = stack("enc_blocks", cfg.encoder_layers)
        port["enc_ln"] = t(tree["enc_ln"]["scale"])
        port["dec_blocks"] = stack("dec_blocks", cfg.n_layers)
        return EncDecLM(cfg, port, trainable=trainable)
    if cfg.family == "vlm":
        n_super, per = vlm_layout(cfg)
        port["self_blocks"] = stack("self_blocks", n_super * per)
        port["cross_blocks"] = stack("cross_blocks", n_super)
        return VisionLM(cfg, port, trainable=trainable)
    if cfg.family == "ssm":
        def xblock(p, kind, names, i):
            """Layer ``i`` of a stacked mLSTM or sLSTM tree."""
            s, (dense, f32) = p[kind], names
            return {"ln": t(p["ln"]["scale"][i]), kind: {
                **{n: t(s[n]["kernel"][i], dt) for n in dense},
                **{n: t(s[n][i]) for n in f32},
                "norm": t(s["norm"]["scale"][i]),
            }}

        n_m, n_s = xlstm_counts(cfg)
        port["mblocks"] = [xblock(tree["mblocks"], "mlstm", _MLSTM, i)
                           for i in range(n_m)]
        port["sblocks"] = [xblock(tree["sblocks"], "slstm", _SLSTM, i)
                           for i in range(n_s)]
        return XLSTMLM(cfg, port, trainable=trainable)
    n_groups, tail = layout(cfg)
    port["mblocks"] = [mamba(tree["mblocks"], i)
                       for i in range(n_groups * cfg.shared_attn_every)]
    port["tail"] = [mamba(tree["tail"], i) for i in range(tail)]
    port["shared"] = block(tree["shared"])
    return ZambaLM(cfg, port, trainable=trainable)


def lm_leaf_paths(cfg: ModelConfig, tree):
    """(port parameter name, reference tree path, stacked layer or None)
    of every leaf of an LM of any ported family, in the reference's tree
    order: a stacked leaf (``blocks``, ``mblocks``, ``tail``, ``sblocks``,
    ``enc_blocks``, ``dec_blocks``, ``self_blocks``, ``cross_blocks``)
    once per layer, zamba's one ``shared`` block once.  A family without a
    branch here raises: its tree would be walked as another's."""
    yield "embed", ("embed", "table"), None
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            yield from _block_paths(cfg, f"blocks.{i}", "blocks", i)
    elif cfg.family == "hybrid":
        n_groups, tail = layout(cfg)
        for i in range(n_groups * cfg.shared_attn_every):
            yield from _mamba_paths(f"mblocks.{i}", "mblocks", i)
        yield from _block_paths(cfg, "shared", "shared", None)
        for i in range(tail):
            yield from _mamba_paths(f"tail.{i}", "tail", i)
    elif cfg.family == "audio":
        for i in range(cfg.encoder_layers):
            yield from _block_paths(cfg, f"enc_blocks.{i}", "enc_blocks", i)
        yield "enc_ln", ("enc_ln", "scale"), None
        for i in range(cfg.n_layers):
            yield from _block_paths(cfg, f"dec_blocks.{i}", "dec_blocks", i,
                                    cross=True)
    elif cfg.family == "vlm":
        n_super, per = vlm_layout(cfg)
        for r in range(n_super * per):
            yield from _block_paths(cfg, f"self_blocks.{r}", "self_blocks",
                                    r)
        for i in range(n_super):
            yield from _block_paths(cfg, f"cross_blocks.{i}",
                                    "cross_blocks", i, cross=True)
    elif cfg.family == "ssm":
        n_m, n_s = xlstm_counts(cfg)
        for root, kind, names, n in (("mblocks", "mlstm", _MLSTM, n_m),
                                     ("sblocks", "slstm", _SLSTM, n_s)):
            dense, f32 = names
            for i in range(n):
                b = f"{root}.{i}"
                yield f"{b}.ln", (root, "ln", "scale"), i
                for m in dense:
                    yield f"{b}.{kind}.{m}", (root, kind, m, "kernel"), i
                for m in f32:
                    yield f"{b}.{kind}.{m}", (root, kind, m), i
                yield f"{b}.{kind}.norm", (root, kind, "norm", "scale"), i
    else:
        raise ValueError(f"no leaf paths for family {cfg.family!r}")
    yield "ln_f", ("ln_f", "scale"), None
    if "unembed" in tree:
        yield "unembed", ("unembed", "kernel"), None


def param_shapes(cfg: ModelConfig):
    """Every parameter's shape, keyed by its port name, from the config
    alone (nothing is allocated)."""
    pv, d = padded_vocab(cfg), cfg.d_model
    tops = {"embed": (pv, d), "unembed": (d, pv), "ln_f": (d,),
            "enc_ln": (d,)}
    tied = cfg.family in ("dense", "moe") and cfg.tie_embeddings
    return {name: tops[name] if name in tops else _param_shape(cfg, path)
            for name, path, _ in lm_leaf_paths(cfg, {} if tied
                                               else {"unembed": None})}


def _block_paths(cfg: ModelConfig, b: str, root: str, i, *,
                 cross: bool = False):
    """The leaves of one decoder block: layer ``i`` of the stacked
    ``root``, or the one block ``root`` when ``i`` is None; a ``cross``
    block adds ``ln_x``, ``xattn`` and the scalar ``xgate``."""
    yield f"{b}.ln1", (root, "ln1", "scale"), i
    for n in _ATTN:
        yield f"{b}.attn.{n}", (root, "attn", n, "kernel"), i
    yield f"{b}.ln2", (root, "ln2", "scale"), i
    if cfg.is_moe:
        yield f"{b}.moe.router", (root, "moe", "router", "kernel"), i
        for n in _MLP:
            yield f"{b}.moe.{n}", (root, "moe", n), i
    else:
        for n in _MLP:
            yield f"{b}.mlp.{n}", (root, "mlp", n, "kernel"), i
    if cross:
        yield f"{b}.ln_x", (root, "ln_x", "scale"), i
        for n in _ATTN:
            yield f"{b}.xattn.{n}", (root, "xattn", n, "kernel"), i
        yield f"{b}.xgate", (root, "xgate"), i


def _mamba_paths(b: str, root: str, i: int):
    yield f"{b}.ln", (root, "ln", "scale"), i
    yield f"{b}.ssm.in_proj", (root, "ssm", "in_proj", "kernel"), i
    for n in _SSM_F32:
        yield f"{b}.ssm.{n}", (root, "ssm", n), i
    yield f"{b}.ssm.norm", (root, "ssm", "norm", "scale"), i
    yield f"{b}.ssm.out_proj", (root, "ssm", "out_proj", "kernel"), i


def adamw_state_from_numpy(state, cfg: ModelConfig,
                           device: DeviceLike = None, *, shardings=None):
    """The port's AdamW state (``{"mu": {name: {"m", "v"}}, "count"}``)
    holding a reference AdamW state whose leaves are numpy arrays.

    fp32 and bf16 moments are sliced per layer.  An int8 moment is one
    quantised leaf over all layers of a stacked parameter; its blocks are
    split between the layers, which is exact when a layer's element count
    is a whole number of blocks, and for a stacked scalar (a cross block's
    ``xgate``: each layer's value one element of a block the layers share,
    carried with that block's scale); otherwise it raises.  With
    ``shardings`` (parameter name -> its moments' placement on a mesh)
    each fp32 or bf16 moment holds this rank's block."""
    dev = resolve_device(device)
    mu = state["mu"]

    def leaf(path):
        node = mu
        for k in path:
            node = node[k]
        return node

    def moment(a, i, n_layer):
        if isinstance(a, dict):                        # int8 {"q", "scale"}
            q, scale = np.asarray(a["q"]), np.asarray(a["scale"])
            if i is not None:
                q, scale = _int8_layer(q, scale, i, n_layer)
            return {"q": torch.from_numpy(np.array(q)).to(dev),
                    "scale": torch.from_numpy(
                        np.array(scale, np.float32)).to(dev)}
        a = np.asarray(a) if i is None else np.asarray(a)[i]
        dt = torch.bfloat16 if str(a.dtype) == "bfloat16" else torch.float32
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    out = {}
    for name, path, i in lm_leaf_paths(cfg, mu):
        mv = leaf(path)
        shape = np.shape(mv["m"]) if not isinstance(mv["m"], dict) else None
        n_layer = None
        if i is not None and shape is None:
            n_layer = int(np.prod(_param_shape(cfg, path)))
        out[name] = {k: moment(mv[k], i, n_layer) for k in ("m", "v")}
        if shardings is not None:
            out[name] = {k: shardings[name].shard(t).contiguous().clone()
                         for k, t in out[name].items()}
    count = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                         device=dev)
    return {"mu": out, "count": count}


def _int8_layer(q, scale, i: int, n_layer: int):
    """Layer ``i``'s (q, scale) blocks, in the port's layout, of a stacked
    leaf's int8 blocks ``q`` (nb, QBLOCK) and ``scale`` (nb, 1)."""
    if n_layer % QBLOCK == 0:
        rows = n_layer // QBLOCK
        return q[i * rows:(i + 1) * rows], scale[i * rows:(i + 1) * rows]
    if n_layer != 1:
        raise ValueError(
            f"a layer of {n_layer} elements is not a whole number of "
            f"{QBLOCK}-element blocks: the int8 state does not split "
            "between the layers")
    one = np.zeros((1, QBLOCK), q.dtype)
    one[0, 0] = q.reshape(-1)[i]
    return one, scale[i // QBLOCK][None]


def _param_shape(cfg: ModelConfig, path):
    """One layer's shape of the stacked parameter at ``path``."""
    d, hd = cfg.d_model, cfg.head_dim
    if path[1] == "ln":                    # a mamba, mLSTM or sLSTM block
        return (d,)
    if path[1] in ("ssm", "mlstm", "slstm"):
        return _mixer_shapes(cfg, path[1])[path[2]]
    if path[1] == "xgate":                 # a cross block's scalar gate
        return ()
    name = path[-2] if path[-1] in ("kernel", "scale") else path[-1]
    if path[1] in ("ln1", "ln2", "ln_x"):
        return (d,)
    if path[1] in ("attn", "xattn"):
        heads = cfg.n_heads if name in ("wq", "wo") else cfg.n_kv_heads
        return (heads * hd, d) if name == "wo" else (d, heads * hd)
    if path[1] == "moe":
        e, f = cfg.n_experts, cfg.moe_d_ff
        return {"router": (d, e), "gate": (e, d, f), "up": (e, d, f),
                "down": (e, f, d)}[name]
    return {"gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
            "down": (cfg.d_ff, d)}[name]


def _mixer_shapes(cfg: ModelConfig, kind: str):
    """Each leaf's shape in one mamba (``ssm``), mLSTM or sLSTM layer."""
    d = cfg.d_model
    if kind == "ssm":
        di, n, h = cfg.d_inner, cfg.ssm_state or 64, cfg.n_ssm_heads
        return {"in_proj": (d, 2 * di + 2 * n + h),
                "conv": (cfg.ssm_conv, di + 2 * n), "A_log": (h,),
                "D": (h,), "dt_bias": (h,), "norm": (di,),
                "out_proj": (di, d)}
    if kind == "mlstm":
        di, h = 2 * d, cfg.n_heads
        return {"up_l": (d, di), "up_r": (d, di), "wq": (di, di),
                "wk": (di, di), "wv": (di, di), "w_if": (di, 2 * h),
                "b_if": (2 * h,), "norm": (di,), "down": (di, d)}
    return {"wx": (d, 4 * d), "wh": (d, 4 * d), "bias": (4 * d,),
            "norm": (d,), "proj": (d, d)}
