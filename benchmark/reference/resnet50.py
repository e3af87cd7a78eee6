"""ResNet-50 (He et al. 2016, arXiv:1512.03385, Table 1, the 50-layer column)
in plain PyTorch: the benchmark's reference for the ``resnet50``
configuration.

Bottleneck blocks [3, 4, 6, 3] of widths 64-256 ... 512-2048, a 7x7/2 stem
and a 3x3/2 max pool, a global average pool and a 1000-way classifier, with
each batch norm folded into its conv (every conv carries a bias, as the
measured program serves ResNets).  Parameter names are torchvision's.

Quantization sites are numbered in the order the original ``*WithId``
layers were built: the stem conv, then per stage the downsample conv before
the convs of the stage's first block.  A site is ``(id, tag, half_range)``;
``half_range`` marks the outputs a ReLU follows.

``forward(P, x, ops)`` walks the network and asks ``ops`` (``layers.py``) for
every conv, pool and residual, so one walk serves the float, statistics,
simulation and integer-serving arithmetic.
"""

from __future__ import annotations

import torch

DEPTHS = (3, 4, 6, 3)
ARCH = 'resnet50'


def layout():
    """(stem site, maxpool site, blocks, avgpool site, classifier site); a
    block is a dict of its name, widths, stride and sites."""
    count = {}

    def site(kind, tag, half=False, suffix='activation'):
        i = count.get(kind, 0)
        count[kind] = i + 1
        return (f'{kind}{i}_{suffix}', tag, half)

    def conv(half=False):
        s = site('conv', 'activation', half)
        site('bn', 'activation', half)   # the folded BN keeps its number
        return s

    stem = conv(half=True)
    pool = site('maxpool', 'activation_pooling', suffix='out')
    blocks, in_planes = [], 64
    for si, depth in enumerate(DEPTHS):
        planes = 64 * 2 ** si
        for bi in range(depth):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            ds = conv() if bi == 0 and (stride != 1 or in_planes != planes * 4) else None
            blocks.append({'name': f'layer{si + 1}.{bi}', 'in': in_planes, 'width': planes,
                           'out': planes * 4, 'stride': stride, 'ds': ds,
                           'sites': (conv(half=True), conv(half=True), conv())})
            in_planes = planes * 4
    avg = site('avgpool', 'default', suffix='out')
    fc = site('linear', 'activation_classifier')
    return stem, pool, blocks, avg, fc


def forward(P, x, ops):
    """Logits [N, 1000] of the NCHW float32 images ``x``."""
    stem, pool, blocks, avg, fc = layout()
    x = ops.conv(P, x, 'conv1', (2, 2), (3, 3), 1, stem)
    x = torch.relu(x)
    x = ops.stem_out(x, blocks[0]['sites'][0])
    x = ops.maxpool(x, 3, 2, 1, pool)
    for b in blocks:
        n = b['name']
        c1, c2, c3 = b['sites']
        x_in, identity = ops.block_input(x, c1)
        out = ops.conv(P, x_in, f'{n}.conv1', (1, 1), (0, 0), 1, c1)
        out = ops.conv(P, torch.relu(out), f'{n}.conv2', (b['stride'],) * 2, (1, 1), 1, c2)
        out = ops.conv(P, torch.relu(out), f'{n}.conv3', (1, 1), (0, 0), 1, c3)
        if b['ds'] is not None:
            identity = ops.conv(P, x_in, f'{n}.downsample.0', (b['stride'],) * 2, (0, 0), 1,
                                b['ds'], out_codes=True)
        x = ops.residual(out, identity)
    x = ops.avgpool(x, avg)
    return ops.linear(P, x.flatten(1), 'fc', fc).float()


def sites():
    stem, pool, blocks, avg, fc = layout()
    out = [stem, pool]
    for b in blocks:
        if b['ds'] is not None:
            out.append(b['ds'])
        out += list(b['sites'])
    return out + [avg, fc]


def param_shapes():
    """{name: shape} of every float parameter."""
    _, _, blocks, _, _ = layout()
    out = {'conv1.weight': (64, 3, 7, 7), 'conv1.bias': (64,)}
    for b in blocks:
        n, w = b['name'], b['width']
        convs = [(f'{n}.conv1', (w, b['in'], 1, 1)), (f'{n}.conv2', (w, w, 3, 3)),
                 (f'{n}.conv3', (b['out'], w, 1, 1))]
        if b['ds'] is not None:
            convs.append((f'{n}.downsample.0', (b['out'], b['in'], 1, 1)))
        for name, shape in convs:
            out[f'{name}.weight'], out[f'{name}.bias'] = shape, (shape[0],)
    out['fc.weight'], out['fc.bias'] = (1000, 2048), (1000,)
    return out
