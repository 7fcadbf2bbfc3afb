"""Flat parameter names and shapes of the caption model, from a
configuration file's keys alone.

The names are the checkpoint's flat names (``params/cnn/conv1_1/conv/kernel``,
``params/decoder/lstm/kernel``, ``batch_stats/...``): conv kernels HWIO,
dense kernels ``[in, out]``.  The benchmark draws its weights under these
names and hands the same flat dict to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

# (name, features, max pool after) of VGG16's 13 convs (arXiv:1409.1556, config D)
VGG_LAYERS = [
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, True),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
]

# (stage, bottleneck width, identity blocks, first block's stride) of ResNet50 (arXiv:1512.03385)
RESNET_STAGES = [("2", 64, 2, 1), ("3", 128, 3, 2), ("4", 256, 5, 2), ("5", 512, 2, 2)]


def resnet_blocks() -> Iterator[Tuple[str, str, int, int, bool]]:
    """(block, tag, width, stride, projection) of the 16 bottleneck blocks."""
    for prefix, width, n_identity, stride in RESNET_STAGES:
        yield f"res{prefix}a", f"{prefix}a", width, stride, True
        for i in range(n_identity):
            tag = f"{prefix}{chr(ord('b') + i)}"
            yield f"res{tag}", tag, width, 1, False


def resnet_convs() -> Iterator[Tuple[str, str, str, int, int, int, int]]:
    """(block, conv, batch norm, kernel, in, out, stride) of every conv."""
    yield "", "conv1", "bn_conv1", 7, 3, 64, 2
    cin = 64
    for block, tag, width, stride, projection in resnet_blocks():
        if projection:
            yield block, f"res{tag}_branch1", f"bn{tag}_branch1", 1, cin, 4 * width, stride
        yield block, f"res{tag}_branch2a", f"bn{tag}_branch2a", 1, cin, width, stride
        yield block, f"res{tag}_branch2b", f"bn{tag}_branch2b", 3, width, width, 1
        yield block, f"res{tag}_branch2c", f"bn{tag}_branch2c", 1, width, 4 * width, 1
        cin = 4 * width


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Flat name -> shape of every parameter (and ResNet50's running
    statistics) of the model that ``cfg`` describes."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    if cfg["cnn"] == "vgg16":
        cin = 3
        for name, features, _ in VGG_LAYERS:
            shapes[f"params/cnn/{name}/conv/kernel"] = (3, 3, cin, features)
            shapes[f"params/cnn/{name}/conv/bias"] = (features,)
            cin = features
    else:
        for block, conv, bn, k, cin, cout, _ in resnet_convs():
            at = f"{block}/" if block else ""
            shapes[f"params/cnn/{at}{conv}/conv/kernel"] = (k, k, cin, cout)
            if conv == "conv1":
                shapes["params/cnn/conv1/conv/bias"] = (cout,)
            for leaf, prefix in (("scale", "params/cnn/"), ("bias", "params/cnn/"),
                                 ("mean", "batch_stats/"), ("var", "batch_stats/")):
                shapes[f"{prefix}{at}{bn}/{leaf}"] = (cout,)
    E, H, D = cfg["dim_embedding"], cfg["num_lstm_units"], cfg["dim_ctx"]
    V, da, di, dd = cfg["vocabulary_size"], cfg["dim_attend_layer"], cfg["dim_initialize_layer"], cfg["dim_decode_layer"]
    dec = "params/decoder/"

    def dense(name, d_in, d_out, bias=True):
        shapes[f"{dec}{name}/kernel"] = (d_in, d_out)
        if bias:
            shapes[f"{dec}{name}/bias"] = (d_out,)

    shapes[f"{dec}word_embedding/weights"] = (V, E)
    shapes[f"{dec}lstm/kernel"] = (D + E + H, 4 * H)
    shapes[f"{dec}lstm/bias"] = (4 * H,)
    dense("initialize/fc_a1", D, di)
    dense("initialize/fc_a2", di, H)
    dense("initialize/fc_b1", D, di)
    dense("initialize/fc_b2", di, H)
    dense("attend/fc_1a", D, da)
    dense("attend/fc_1b", H, da)
    dense("attend/fc_2", da, 1, bias=False)
    dense("decode/fc_1", H + D + E, dd)
    dense("decode/fc_2", dd, V)
    return shapes
