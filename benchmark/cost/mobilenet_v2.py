"""Operations of MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2)
at a width and input size, from the configuration file: every
convolution and the classifier, 2 operations a multiply-add; batch norm,
ReLU6, the residual adds and the pooling not counted."""

from __future__ import annotations


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel counts rounded the MobileNet way (multiples of 8)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def conv_layers(cfg: dict):
    """(kernel, cin, cout, groups, out_h, out_w) of every convolution in
    order, then the classifier as a 1x1 "conv" on a 1x1 map."""
    width = float(cfg["width_multiplier"])
    size = int(cfg["input_size"])

    def out(n, s):
        return -(-n // s)          # SAME padding

    layers = []
    h = out(size, 2)
    cin = make_divisible(int(cfg["first_channels"]) * width)
    layers.append((3, 3, cin, 1, h, h))
    for t, c, n, s in cfg["inverted_residual_setting"]:
        cout = make_divisible(c * width)
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                layers.append((1, cin, hidden, 1, h, h))
            h = out(h, stride)
            layers.append((3, hidden, hidden, hidden, h, h))
            layers.append((1, hidden, cout, 1, h, h))
            cin = cout
    last = make_divisible(int(cfg["last_channels"]) * max(1.0, width))
    layers.append((1, cin, last, 1, h, h))
    layers.append((1, last, int(cfg["num_classes"]), 1, 1, 1))
    return layers


def frame_flops(cfg: dict) -> int:
    """Operations for one frame."""
    return sum(2 * k * k * (cin // g) * cout * oh * ow
               for k, cin, cout, g, oh, ow in conv_layers(cfg))
