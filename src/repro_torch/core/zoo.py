"""Graph constructors for the paper's evaluation models (Table 4, Fig. 12/14).

All dimensions follow the paper where specified.  Hidden sizes of Models
A/B/D are not given in the paper; we use 64/128 chosen to match the
published ideal-memory numbers within <0.5% (see EXPERIMENTS.md §Table4).
"""

from __future__ import annotations

from typing import List

from repro_torch.core.graph import LayerGraph, LayerNode, compile_graph

# Paper's component inputs: 64:1:1:150528 (linear/lstm), 64:3:224:224 (conv)
LINEAR_IN = 150528
IMG_IN = (3, 224, 224)


def _g(layers: List[LayerNode], input_shape, label_shape, name: str,
       **compile_kw) -> LayerGraph:
    return compile_graph(LayerGraph(layers, tuple(input_shape), tuple(label_shape),
                                    name), **compile_kw)


# ---------------------------------------------------------------------------
# Table 4 component test cases
# ---------------------------------------------------------------------------

def single_linear() -> LayerGraph:
    """Linear: 64:1:1:150528 -> 64:1:1:10, MSE."""
    return _g([
        LayerNode("fc0", "linear", ["__input__"],
                  {"in_features": LINEAR_IN, "out_features": 10, "bias": False}),
        LayerNode("loss", "loss_mse", ["fc0"]),
    ], (LINEAR_IN,), (10,), "single_linear")


def single_conv2d() -> LayerGraph:
    """Conv2D: 64:3:224:224 -> 64:3:112:112 (3 filters 3x3, stride 2), MSE."""
    return _g([
        LayerNode("conv0", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False}),
        LayerNode("loss", "loss_mse", ["conv0"]),
    ], IMG_IN, (3, 112, 112), "single_conv2d")


def single_lstm() -> LayerGraph:
    """LSTM: 64:1:1:150528 -> 64:1:1:10 (single step, hidden=10), MSE."""
    return _g([
        LayerNode("lstm0", "lstm", ["__input__"],
                  {"in_features": LINEAR_IN, "hidden": 10, "seq_len": 1}),
        LayerNode("loss", "loss_mse", ["lstm0"]),
    ], (LINEAR_IN,), (10,), "single_lstm")


def model_a(variant: str = "linear") -> LayerGraph:
    """Model A (Fig. 1/4): three weighted layers, no in-place ops."""
    if variant == "linear":
        d1, d2 = 128, 128
        layers = [
            LayerNode("fc0", "linear", ["__input__"],
                      {"in_features": LINEAR_IN, "out_features": d1, "bias": False}),
            LayerNode("fc1", "linear", ["fc0"],
                      {"in_features": d1, "out_features": d2, "bias": False}),
            LayerNode("fc2", "linear", ["fc1"],
                      {"in_features": d2, "out_features": 10, "bias": False}),
            LayerNode("loss", "loss_mse", ["fc2"]),
        ]
        return _g(layers, (LINEAR_IN,), (10,), "model_a_linear")
    # conv variant: 3 stride-2 convs 224 -> 112 -> 56 -> 28
    layers = [
        LayerNode("conv0", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False}),
        LayerNode("conv1", "conv2d", ["conv0"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False}),
        LayerNode("conv2", "conv2d", ["conv1"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False}),
        LayerNode("loss", "loss_mse", ["conv2"]),
    ]
    return _g(layers, IMG_IN, (3, 28, 28), "model_a_conv2d")


def model_b(variant: str = "linear") -> LayerGraph:
    """Model B (Fig. 5): weighted -> in-place activation -> weighted."""
    if variant == "linear":
        d = 64
        layers = [
            LayerNode("fc0", "linear", ["__input__"],
                      {"in_features": LINEAR_IN, "out_features": d, "bias": False,
                       "activation": "sigmoid"}),
            LayerNode("fc1", "linear", ["fc0"],
                      {"in_features": d, "out_features": 10, "bias": False}),
            LayerNode("loss", "loss_mse", ["fc1"]),
        ]
        return _g(layers, (LINEAR_IN,), (10,), "model_b_linear")
    layers = [
        LayerNode("conv0", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False, "activation": "sigmoid"}),
        LayerNode("conv1", "conv2d", ["conv0"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False}),
        LayerNode("loss", "loss_mse", ["conv1"]),
    ]
    return _g(layers, IMG_IN, (3, 56, 56), "model_b_conv2d")


def model_c(variant: str = "linear") -> LayerGraph:
    """Model C (Fig. 6): weighted -> activation (in-place) -> flatten (RV)."""
    if variant == "linear":
        layers = [
            LayerNode("fc0", "linear", ["__input__"],
                      {"in_features": LINEAR_IN, "out_features": 10, "bias": False,
                       "activation": "sigmoid"}),
            LayerNode("flat", "flatten", ["fc0"]),
            LayerNode("loss", "loss_mse", ["flat"]),
        ]
        return _g(layers, (LINEAR_IN,), (10,), "model_c_linear")
    layers = [
        LayerNode("conv0", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 3, "ksize": 3, "stride": 2,
                   "padding": "same", "bias": False, "activation": "sigmoid"}),
        LayerNode("flat", "flatten", ["conv0"]),
        LayerNode("loss", "loss_mse", ["flat"]),
    ]
    return _g(layers, IMG_IN, (37632,), "model_c_conv2d")


def model_d() -> LayerGraph:
    """Model D (§5.1): input -> multi-out -> two activation branches ->
    addition -> linear -> loss."""
    layers = [
        LayerNode("mo", "multiout", ["__input__"]),
        LayerNode("act_a", "activation", ["mo"], {"fn": "sigmoid"}),
        LayerNode("act_b", "activation", ["mo"], {"fn": "tanh"}),
        LayerNode("add0", "add", ["act_a", "act_b"]),
        LayerNode("fc", "linear", ["add0"],
                  {"in_features": LINEAR_IN, "out_features": 10, "bias": False}),
        LayerNode("loss", "loss_mse", ["fc"]),
    ]
    return _g(layers, (LINEAR_IN,), (10,), "model_d")


# ---------------------------------------------------------------------------
# Fig. 12 application models (CIFAR-like 32x32x3 input, 10/100 classes)
# ---------------------------------------------------------------------------

def lenet5(num_classes: int = 10) -> LayerGraph:
    layers = [
        LayerNode("c1", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 6, "ksize": 5, "stride": 1,
                   "padding": "same", "activation": "tanh"}),
        LayerNode("p1", "pool2d", ["c1"], {"ksize": 2, "stride": 2}),
        LayerNode("c2", "conv2d", ["p1"],
                  {"in_ch": 6, "out_ch": 16, "ksize": 5, "stride": 1,
                   "padding": "valid", "activation": "tanh"}),
        LayerNode("p2", "pool2d", ["c2"], {"ksize": 2, "stride": 2}),
        LayerNode("f5", "linear", ["p2"],
                  {"in_features": 16 * 6 * 6, "out_features": 120,
                   "activation": "tanh"}),
        LayerNode("f6", "linear", ["f5"],
                  {"in_features": 120, "out_features": 84, "activation": "tanh"}),
        LayerNode("f7", "linear", ["f6"],
                  {"in_features": 84, "out_features": num_classes,
                   "activation": "softmax"}),
        LayerNode("loss", "loss_ce", ["f7"]),
    ]
    return _g(layers, (3, 32, 32), (num_classes,), "lenet5")


def _vgg_block(name: str, in_ch: int, out_ch: int, convs: int,
               prev: str) -> List[LayerNode]:
    out: List[LayerNode] = []
    for i in range(convs):
        out.append(LayerNode(
            f"{name}_c{i}", "conv2d", [prev],
            {"in_ch": in_ch if i == 0 else out_ch, "out_ch": out_ch,
             "ksize": 3, "stride": 1, "padding": "same", "activation": "relu"}))
        prev = f"{name}_c{i}"
    out.append(LayerNode(f"{name}_p", "pool2d", [prev], {"ksize": 2, "stride": 2}))
    return out


def vgg16(num_classes: int = 10) -> LayerGraph:
    layers: List[LayerNode] = []
    prev = "__input__"
    for bi, (cin, cout, n) in enumerate(
            [(3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3)]):
        blk = _vgg_block(f"b{bi}", cin, cout, n, prev)
        layers.extend(blk)
        prev = blk[-1].name
    layers += [
        LayerNode("fc0", "linear", [prev],
                  {"in_features": 512, "out_features": 512, "activation": "relu"}),
        LayerNode("fc1", "linear", ["fc0"],
                  {"in_features": 512, "out_features": num_classes,
                   "activation": "softmax"}),
        LayerNode("loss", "loss_ce", ["fc1"]),
    ]
    return _g(layers, (3, 32, 32), (num_classes,), "vgg16")


def _res_block(name: str, in_ch: int, out_ch: int, stride: int,
               prev: str) -> List[LayerNode]:
    out = [
        LayerNode(f"{name}_c0", "conv2d", [prev],
                  {"in_ch": in_ch, "out_ch": out_ch, "ksize": 3, "stride": stride,
                   "padding": "same", "activation": "relu"}),
        LayerNode(f"{name}_c1", "conv2d", [f"{name}_c0"],
                  {"in_ch": out_ch, "out_ch": out_ch, "ksize": 3, "stride": 1,
                   "padding": "same"}),
    ]
    if stride != 1 or in_ch != out_ch:
        out.append(LayerNode(f"{name}_sc", "conv2d", [prev],
                             {"in_ch": in_ch, "out_ch": out_ch, "ksize": 1,
                              "stride": stride, "padding": "same"}))
        skip = f"{name}_sc"
    else:
        skip = prev
    out.append(LayerNode(f"{name}_add", "add", [f"{name}_c1", skip],
                         {"activation": "relu"}))
    return out


def resnet18(num_classes: int = 10) -> LayerGraph:
    layers: List[LayerNode] = [
        LayerNode("stem", "conv2d", ["__input__"],
                  {"in_ch": 3, "out_ch": 64, "ksize": 3, "stride": 1,
                   "padding": "same", "activation": "relu"}),
    ]
    prev = "stem"
    cfg = [(64, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
           (128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
    for i, (cin, cout, s) in enumerate(cfg):
        blk = _res_block(f"r{i}", cin, cout, s, prev)
        layers.extend(blk)
        prev = blk[-1].name
    layers += [
        LayerNode("gap", "pool2d", [prev], {"ksize": 4, "stride": 4}),
        LayerNode("fc", "linear", ["gap"],
                  {"in_features": 512, "out_features": num_classes,
                   "activation": "softmax"}),
        LayerNode("loss", "loss_ce", ["fc"]),
    ]
    return _g(layers, (3, 32, 32), (num_classes,), "resnet18")


def resnet18_transfer(num_classes: int = 10) -> LayerGraph:
    """Fig. 12 'Transfer': ResNet18 backbone frozen, classifier trainable."""
    g = resnet18(num_classes)
    from repro_torch.core.graph import slice_realizer
    return slice_realizer(g, freeze_until="gap")


def product_rating(num_users: int = 6040, num_items: int = 193610,
                   dim: int = 64) -> LayerGraph:
    """Fig. 12 'Rating': NCF-style — embeddings -> concat -> 3 linear (§5.2)."""
    layers = [
        LayerNode("emb_u", "embedding", ["__input__"],
                  {"vocab": num_users, "dim": dim}),
        LayerNode("emb_i", "embedding", ["__input__"],
                  {"vocab": num_items, "dim": dim}),
        LayerNode("cat", "concat", ["emb_u", "emb_i"], {"axis": -1}),
        LayerNode("fc0", "linear", ["cat"],
                  {"in_features": 2 * dim, "out_features": 128, "activation": "relu"}),
        LayerNode("fc1", "linear", ["fc0"],
                  {"in_features": 128, "out_features": 64, "activation": "relu"}),
        LayerNode("fc2", "linear", ["fc1"], {"in_features": 64, "out_features": 1}),
        LayerNode("loss", "loss_mse", ["fc2"]),
    ]
    return _g(layers, (1,), (1,), "product_rating")


# ---------------------------------------------------------------------------
# Fig. 14: Tacotron2-style decoder (prenet + 2 LSTM + projections + postnet)
# ---------------------------------------------------------------------------

def tacotron2_decoder(time_steps: int = 8, mel_dim: int = 80,
                      prenet_dim: int = 256, lstm_dim: int = 256) -> LayerGraph:
    """Time-unrolled LSTM decoder with E-shared weights (§5.2).

    The recurrent section (prenet->lstm->lstm->proj) is unrolled
    ``time_steps`` times by the Recurrent realizer; weights are shared via
    CreateMode.EXTEND and gradients accumulate with Iteration lifespan.
    """
    # E-shared unrolled copies require in_features == hidden for the
    # self-feeding LSTM chain (weight shapes must match across copies)
    assert prenet_dim == lstm_dim, "unrolled LSTM needs prenet_dim == lstm_dim"
    layers = [
        LayerNode("prenet0", "linear", ["__input__"],
                  {"in_features": mel_dim, "out_features": prenet_dim,
                   "activation": "relu"}),
        LayerNode("prenet1", "linear", ["prenet0"],
                  {"in_features": prenet_dim, "out_features": prenet_dim,
                   "activation": "relu"}),
        LayerNode("lstm0", "lstm", ["prenet1"],
                  {"in_features": prenet_dim, "hidden": lstm_dim, "seq_len": 1,
                   "accumulate_grad": True}),
        LayerNode("lstm1", "lstm", ["lstm0"],
                  {"in_features": lstm_dim, "hidden": lstm_dim, "seq_len": 1,
                   "accumulate_grad": True}),
        LayerNode("proj_mel", "linear", ["lstm1"],
                  {"in_features": lstm_dim, "out_features": mel_dim,
                   "accumulate_grad": True}),
        LayerNode("loss", "loss_mse", ["proj_mel"]),
    ]
    return _g(layers, (mel_dim,), (mel_dim,), "tacotron2_decoder",
              unroll={"lstm0": time_steps, "lstm1": time_steps})


def transformer_mlp_stack(n_layers: int = 28, d_model: int = 3072,
                          d_ff: int = 8192) -> LayerGraph:
    """The llama3.2-3b MLP trunk as a layer graph: 28 x (up-proj 3072->8192,
    activation, down-proj 8192->3072), MSE head.

    The dependence analyser's scaling benchmark: per-op Python dispatch
    costs grow with the 3N phase count (28 layers -> hundreds of lowered
    ops) while the fusion prover should collapse the op list into a few
    dozen jit blocks.  Not in the ZOO dict — attention/GQA are absent, so
    it is a dispatch-count workload, not an accuracy workload."""
    layers: List[LayerNode] = []
    prev = "__input__"
    for i in range(n_layers):
        up, down = f"l{i}_up", f"l{i}_down"
        layers += [
            LayerNode(up, "linear", [prev],
                      {"in_features": d_model, "out_features": d_ff,
                       "bias": False, "activation": "relu"}),
            LayerNode(down, "linear", [up],
                      {"in_features": d_ff, "out_features": d_model,
                       "bias": False}),
        ]
        prev = down
    layers.append(LayerNode("loss", "loss_mse", [prev]))
    return _g(layers, (d_model,), (d_model,),
              f"transformer_mlp_stack_{n_layers}l")


ZOO = {
    "linear": single_linear,
    "conv2d": single_conv2d,
    "lstm": single_lstm,
    "model_a_linear": lambda: model_a("linear"),
    "model_a_conv2d": lambda: model_a("conv2d"),
    "model_b_linear": lambda: model_b("linear"),
    "model_b_conv2d": lambda: model_b("conv2d"),
    "model_c_linear": lambda: model_c("linear"),
    "model_c_conv2d": lambda: model_c("conv2d"),
    "model_d": model_d,
    "lenet5": lenet5,
    "vgg16": vgg16,
    "resnet18": resnet18,
    "resnet18_transfer": resnet18_transfer,
    "product_rating": product_rating,
    "tacotron2_decoder": tacotron2_decoder,
}
