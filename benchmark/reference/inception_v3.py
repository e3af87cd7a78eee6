"""Inception-v3 (Szegedy et al. 2016, "Rethinking the Inception Architecture
for Computer Vision", arXiv:1512.00567, Table 1; Figures 5, 6 and 7 are the
mixed blocks A, C and E) in plain PyTorch: the benchmark's reference for the
``inception_v3`` configuration.

The layout is torchvision's ``inception_v3``, the one the paper's quantization
code runs, and so the measured program's: a stem of five convs and two 3x3/2
max pools, eleven mixed blocks (Mixed_5b-5d of kind A, the grid reduction 6a
of kind B, Mixed_6b-6e of kind C, the grid reduction 7a of kind D, Mixed_7b-7c
of kind E), a global mean over the 8x8 grid and a 1000-way classifier; 94
convs at a 299x299 input.  Each conv is followed by a ReLU.  Parameter names
are torchvision's (``Mixed_5b.branch5x5_1.conv``).

Departures from the paper, all torchvision's and the program's:

* every batch norm (eps 1e-3) is folded into its conv's bias, as the program
  serves this network: the parameters are the folded ones, so the walk asks
  ``ops`` for no batch norm;
* the auxiliary classifier is not run at inference; its two convs and its
  linear are built between Mixed_6e and Mixed_7a and take their site numbers
  there (``conv``/``bn`` and ``linear0``), so the classifier is ``linear1``;
* the input is renormalized first (torchvision's ``transform_input``);
* the stem after the first max pool is a 1x1 conv to 80 and a 3x3 conv to
  192, not Table 1's 3x3 convs to 80 and 192 at stride 2 and 1;
* blocks of kind A keep a 5x5 conv in one branch (Figure 5 factorizes it into
  two 3x3), and the 17x17 grid has four blocks of kind C, not five;
* no dropout (inference).

Quantization sites are numbered as the program builds its layers: a conv and
a BN number for each conv (the BN's is never used), the aux tower's between
Mixed_6e and Mixed_7a.  A site is ``(id, tag, half_range)``: every conv's
output but the stem's first is marked half range (the program treats this
fused-ReLU network as positive).  The pools are functional and have no
sites: the branch average pool is 3x3, stride 1, padding 1 with the padding
counted, the stem's and the grid reductions' max pools 3x3, stride 2.
Mixed_7b and Mixed_7c concatenate inside two of their branches as well.

``forward(P, x, ops)`` walks the network and asks ``ops`` (``layers.py``) for
every conv and the classifier, so one walk serves the float, statistics,
simulation and integer-serving arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ARCH = 'inception_v3'
# the two stem convs the program keeps at 8-bit weights in the simulation
EIGHT_BIT_WEIGHTS = ('Conv2d_1a_3x3', 'Conv2d_2a_3x3')

# torchvision's transform_input: x * (std / 0.5) + (mean - 0.5) / 0.5 per channel
TRANSFORM_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
TRANSFORM_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)

# (name, in, out, kernel, stride, padding); a max pool after 2b and after 4a
STEM = (('Conv2d_1a_3x3', 3, 32, 3, 2, 0), ('Conv2d_2a_3x3', 32, 32, 3, 1, 0),
        ('Conv2d_2b_3x3', 32, 64, 3, 1, 1), ('Conv2d_3b_1x1', 64, 80, 1, 1, 0),
        ('Conv2d_4a_3x3', 80, 192, 3, 1, 0))
POOLED = ('Conv2d_2b_3x3', 'Conv2d_4a_3x3')
# (name, kind, the block's argument: pool features for A, c7 for C)
MIXED = (('Mixed_5b', 'A', 32), ('Mixed_5c', 'A', 64), ('Mixed_5d', 'A', 64),
         ('Mixed_6a', 'B', None), ('Mixed_6b', 'C', 128), ('Mixed_6c', 'C', 160),
         ('Mixed_6d', 'C', 160), ('Mixed_6e', 'C', 192), ('Mixed_7a', 'D', None),
         ('Mixed_7b', 'E', None), ('Mixed_7c', 'E', None))


def block_convs(kind: str, c: int, arg) -> tuple:
    """(name, in, out, kernel, stride, padding) of a block's convs, in the
    order they are built; ``c`` is the block's input channels."""
    if kind == 'A':
        return (('branch1x1', c, 64, 1, 1, 0), ('branch5x5_1', c, 48, 1, 1, 0),
                ('branch5x5_2', 48, 64, 5, 1, 2), ('branch3x3dbl_1', c, 64, 1, 1, 0),
                ('branch3x3dbl_2', 64, 96, 3, 1, 1), ('branch3x3dbl_3', 96, 96, 3, 1, 1),
                ('branch_pool', c, arg, 1, 1, 0))
    if kind == 'B':
        return (('branch3x3', c, 384, 3, 2, 0), ('branch3x3dbl_1', c, 64, 1, 1, 0),
                ('branch3x3dbl_2', 64, 96, 3, 1, 1), ('branch3x3dbl_3', 96, 96, 3, 2, 0))
    if kind == 'C':
        return (('branch1x1', c, 192, 1, 1, 0), ('branch7x7_1', c, arg, 1, 1, 0),
                ('branch7x7_2', arg, arg, (1, 7), 1, (0, 3)),
                ('branch7x7_3', arg, 192, (7, 1), 1, (3, 0)),
                ('branch7x7dbl_1', c, arg, 1, 1, 0),
                ('branch7x7dbl_2', arg, arg, (7, 1), 1, (3, 0)),
                ('branch7x7dbl_3', arg, arg, (1, 7), 1, (0, 3)),
                ('branch7x7dbl_4', arg, arg, (7, 1), 1, (3, 0)),
                ('branch7x7dbl_5', arg, 192, (1, 7), 1, (0, 3)),
                ('branch_pool', c, 192, 1, 1, 0))
    if kind == 'D':
        return (('branch3x3_1', c, 192, 1, 1, 0), ('branch3x3_2', 192, 320, 3, 2, 0),
                ('branch7x7x3_1', c, 192, 1, 1, 0),
                ('branch7x7x3_2', 192, 192, (1, 7), 1, (0, 3)),
                ('branch7x7x3_3', 192, 192, (7, 1), 1, (3, 0)),
                ('branch7x7x3_4', 192, 192, 3, 2, 0))
    return (('branch1x1', c, 320, 1, 1, 0), ('branch3x3_1', c, 384, 1, 1, 0),
            ('branch3x3_2a', 384, 384, (1, 3), 1, (0, 1)),
            ('branch3x3_2b', 384, 384, (3, 1), 1, (1, 0)),
            ('branch3x3dbl_1', c, 448, 1, 1, 0), ('branch3x3dbl_2', 448, 384, 3, 1, 1),
            ('branch3x3dbl_3a', 384, 384, (1, 3), 1, (0, 1)),
            ('branch3x3dbl_3b', 384, 384, (3, 1), 1, (1, 0)),
            ('branch_pool', c, 192, 1, 1, 0))


def out_channels(kind: str, c: int, arg) -> int:
    return {'A': 224 + (arg or 0), 'B': 480 + c, 'C': 768, 'D': 512 + c, 'E': 2048}[kind]


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def layout():
    """(stem, blocks, the classifier's input width, the classifier's site):
    the stem a list of (conv spec, site) with the spec's name the module
    path; a block a dict of its name, kind and {branch: (conv spec, site)}."""
    count = {}

    def take(kind):
        i = count.get(kind, 0)
        count[kind] = i + 1
        return i

    def conv_site():
        i = take('conv')
        take('bn')   # the folded BN keeps its number
        return (f'conv{i}_activation', 'activation', i > 0)

    stem = [(spec, conv_site()) for spec in STEM]
    blocks, c = [], 192
    for name, kind, arg in MIXED:
        if name == 'Mixed_7a':   # the aux tower: two convs and linear0, never run
            conv_site()
            conv_site()
            take('linear')
        convs = {}
        for spec in block_convs(kind, c, arg):
            convs[spec[0]] = ((f'{name}.{spec[0]}',) + spec[1:], conv_site())
        blocks.append({'name': name, 'kind': kind, 'convs': convs})
        c = out_channels(kind, c, arg)
    fc = (f"linear{take('linear')}_activation", 'activation_classifier', False)
    return stem, blocks, c, fc


def _conv(P, x, conv, ops):
    """A conv with its folded BN, then the ReLU."""
    (name, _, _, _, stride, padding), site = conv
    return torch.relu(ops.conv(P, x, f'{name}.conv', _pair(stride), _pair(padding), 1, site))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _block(P, x, b, ops):
    """One mixed block: its branches in the program's order, concatenated."""
    def c(branch, y):
        return _conv(P, y, b['convs'][branch], ops)

    kind = b['kind']
    if kind == 'A':
        b1 = c('branch1x1', x)
        b5 = c('branch5x5_2', c('branch5x5_1', x))
        b3 = c('branch3x3dbl_3', c('branch3x3dbl_2', c('branch3x3dbl_1', x)))
        return torch.cat([b1, b5, b3, c('branch_pool', _avg_pool(x))], 1)
    if kind == 'B':
        b3 = c('branch3x3', x)
        bd = c('branch3x3dbl_3', c('branch3x3dbl_2', c('branch3x3dbl_1', x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)
    if kind == 'C':
        b1 = c('branch1x1', x)
        b7 = c('branch7x7_3', c('branch7x7_2', c('branch7x7_1', x)))
        bd = x
        for i in range(1, 6):
            bd = c(f'branch7x7dbl_{i}', bd)
        return torch.cat([b1, b7, bd, c('branch_pool', _avg_pool(x))], 1)
    if kind == 'D':
        b3 = c('branch3x3_2', c('branch3x3_1', x))
        b7 = x
        for i in range(1, 5):
            b7 = c(f'branch7x7x3_{i}', b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)
    b1 = c('branch1x1', x)
    b3 = c('branch3x3_1', x)
    b3 = torch.cat([c('branch3x3_2a', b3), c('branch3x3_2b', b3)], 1)
    bd = c('branch3x3dbl_2', c('branch3x3dbl_1', x))
    bd = torch.cat([c('branch3x3dbl_3a', bd), c('branch3x3dbl_3b', bd)], 1)
    return torch.cat([b1, b3, bd, c('branch_pool', _avg_pool(x))], 1)


def forward(P, x, ops, blocks_out=None):
    """Logits [N, 1000] of the NCHW float32 images ``x``; ``blocks_out`` (a
    dict), where given, receives each mixed block's output by name."""
    stem, blocks, _, fc = layout()
    x = x * x.new_tensor(TRANSFORM_SCALE).view(1, 3, 1, 1) \
        + x.new_tensor(TRANSFORM_SHIFT).view(1, 3, 1, 1)
    for conv in stem:
        x = _conv(P, x, conv, ops)
        if conv[0][0] in POOLED:
            x = _max_pool(x)
    for b in blocks:
        x = _block(P, x, b, ops)
        if blocks_out is not None:
            blocks_out[b['name']] = x
    x = torch.mean(x, dim=(2, 3))
    return ops.linear(P, x, 'fc', fc).float()


def sites():
    stem, blocks, _, fc = layout()
    out = [site for _, site in stem]
    for b in blocks:
        out += [site for _, site in b['convs'].values()]
    return out + [fc]


def param_shapes():
    """{name: shape} of every float parameter, in the program's order."""
    stem, blocks, c, _ = layout()
    out = {}
    convs = [spec for spec, _ in stem]
    for b in blocks:
        convs += [spec for spec, _ in b['convs'].values()]
    for name, cin, cout, k, _, _ in convs:
        out[f'{name}.conv.weight'] = (cout, cin) + _pair(k)
        out[f'{name}.conv.bias'] = (cout,)
    out['fc.weight'], out['fc.bias'] = (1000, c), (1000,)
    return out
