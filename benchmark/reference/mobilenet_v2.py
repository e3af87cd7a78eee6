"""MobileNet-v2 (Sandler et al. 2018, arXiv:1801.04381, Table 2, width 1.0) in
plain PyTorch: the benchmark's reference for the ``mobilenet_v2``
configuration.

A 3x3/2 stem of 32 channels, 17 inverted residual blocks (expansion t,
output c, repeats n, stride s as in the table), a 1x1 head of 1280, a global
mean and a 1000-way classifier.  Every conv is followed by a live batch norm
(none is folded, as the measured program builds this network), ReLU6 after
the expand and depthwise convs, none after the projection; a block adds its
input where stride is 1 and the widths agree.  Parameter names are
torchvision's.  Sites are numbered as the original layers were built: a conv
and a BN number for each conv, the classifier last.
"""

from __future__ import annotations

import torch

ARCH = 'mobilenet_v2'
CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def layout():
    count = {}

    def site(kind, tag):
        i = count.get(kind, 0)
        count[kind] = i + 1
        return (f'{kind}{i}_activation', tag, False)

    def conv_bn():
        return site('conv', 'activation'), site('bn', 'activation')

    stem = conv_bn()
    blocks, in_ch = [], 32
    for t, c, n, s in CFG:
        for b in range(n):
            blocks.append({'in': in_ch, 'out': c, 'stride': s if b == 0 else 1, 't': t,
                           'sites': tuple(conv_bn() for _ in range(3 if t != 1 else 2))})
            in_ch = c
    head = conv_bn()
    fc = site('linear', 'activation_classifier')
    return stem, blocks, head, fc


def relu6(x):
    return torch.clamp(x, 0, 6)


def forward(P, x, ops):
    """Logits [N, 1000] of the NCHW float32 images ``x``."""
    stem, blocks, head, fc = layout()
    x = relu6(ops.bn(P, ops.conv(P, x, 'features.0.0', (2, 2), (1, 1), 1, stem[0]),
                     'features.0.1', stem[1]))
    for i, b in enumerate(blocks, start=1):
        hidden = b['in'] * b['t']
        out, sites, j = x, list(b['sites']), 0
        if b['t'] != 1:
            (cs, bs) = sites.pop(0)
            out = relu6(ops.bn(P, ops.conv(P, out, f'features.{i}.conv.0.0', (1, 1), (0, 0), 1,
                                           cs), f'features.{i}.conv.0.1', bs))
            j = 1
        (cs, bs), (ps, pbs) = sites
        out = relu6(ops.bn(P, ops.conv(P, out, f'features.{i}.conv.{j}.0', (b['stride'],) * 2,
                                       (1, 1), hidden, cs), f'features.{i}.conv.{j}.1', bs))
        out = ops.conv(P, out, f'features.{i}.conv.{j + 1}', (1, 1), (0, 0), 1, ps)
        out = ops.bn(P, out, f'features.{i}.conv.{j + 2}', pbs)
        x = x + out if b['stride'] == 1 and b['in'] == b['out'] else out
    n = len(blocks) + 1
    x = relu6(ops.bn(P, ops.conv(P, x, f'features.{n}.0', (1, 1), (0, 0), 1, head[0]),
                     f'features.{n}.1', head[1]))
    x = torch.mean(x, dim=(2, 3))
    return ops.linear(P, x, 'classifier.1', fc).float()


def sites():
    stem, blocks, head, fc = layout()
    out = list(stem)
    for b in blocks:
        for pair in b['sites']:
            out += list(pair)
    return out + list(head) + [fc]


def param_shapes():
    """{name: shape} of every float parameter and batch-norm buffer."""
    _, blocks, _, _ = layout()
    out = {}

    def conv_bn(prefix, bn_name, shape):
        out[f'{prefix}.weight'] = shape
        for s in ('weight', 'bias', 'running_mean', 'running_var'):
            out[f'{bn_name}.{s}'] = (shape[0],)

    conv_bn('features.0.0', 'features.0.1', (32, 3, 3, 3))
    for i, b in enumerate(blocks, start=1):
        hidden, j = b['in'] * b['t'], 0
        if b['t'] != 1:
            conv_bn(f'features.{i}.conv.0.0', f'features.{i}.conv.0.1', (hidden, b['in'], 1, 1))
            j = 1
        conv_bn(f'features.{i}.conv.{j}.0', f'features.{i}.conv.{j}.1', (hidden, 1, 3, 3))
        conv_bn(f'features.{i}.conv.{j + 1}', f'features.{i}.conv.{j + 2}', (b['out'], hidden, 1, 1))
    n = len(blocks) + 1
    conv_bn(f'features.{n}.0', f'features.{n}.1', (1280, 320, 1, 1))
    out['classifier.1.weight'], out['classifier.1.bias'] = (1000, 1280), (1000,)
    return out
