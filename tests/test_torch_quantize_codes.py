"""The float hand-off: ``int_matmul.quantize_sym_codes``, the int8 codes of
float activations that an integer conv or linear takes in.  On a CUDA tensor
it is one launch of ``csrc/fake_quant.cu``'s codes kernel, or an error where
the kernel takes no such call (``codes_route``); on the CPU it runs the plain
composition ``quantize_sym_codes_plain`` (divide, round, clamp, cast).

The CPU tests hold what the kernel would read, from what the call shows
alone (dtype, layout, the scale's shape, the bits), and that the CPU runs the
plain twin and launches nothing.  The ``cuda`` tests hold the kernel to the
plain composition bit for bit on the card, and that a call it does not take
raises there.  This file imports no JAX, so the card runs it:
``python -m pytest --noconftest -m cuda tests/test_torch_quantize_codes.py``.
"""

import pytest
import torch

from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils import counters

CL = torch.channels_last


def _scale(shape, dtype=torch.float32):
    return torch.full(shape, 0.05, dtype=dtype)


def _x(shape, dtype=torch.float32, fmt=torch.contiguous_format):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=fmt)


# (x, scale, bits) -> (channels, inner, per_channel), or None: what the
# kernel does not read (on the card such a call raises, but a strided view,
# which quantize_sym_codes copies dense first)
LAYOUTS = {
    'scalar_contiguous': (lambda: (_x((2, 3, 4, 5)), _scale(()), 8), (1, 1, False)),
    'scalar_channels_last': (lambda: (_x((2, 3, 4, 5), fmt=CL), _scale(()), 8), (1, 1, False)),
    'scalar_kept_dims': (lambda: (_x((2, 3, 4, 5)), _scale((1, 1, 1, 1)), 4), (1, 1, False)),
    'scalar_bf16': (lambda: (_x((7, 9), torch.bfloat16), _scale((1,)), 8), (1, 1, False)),
    'scalar_matrix': (lambda: (_x((3, 2048)), _scale(()), 8), (1, 1, False)),
    'per_channel_channels_last': (
        lambda: (_x((2, 6, 4, 5), fmt=CL), _scale((6,)).view(1, -1, 1, 1), 8), (6, 1, True)),
    'per_channel_contiguous': (
        lambda: (_x((2, 6, 4, 5)), _scale((6,)).view(1, -1, 1, 1), 4), (6, 20, True)),
    'per_column_matrix': (lambda: (_x((8, 6)), _scale((1, 6)), 8), (6, 1, True)),
    'per_output_channel_weight': (lambda: (_x((16, 4, 3, 3)), _scale((16, 1, 1, 1)), 8),
                                  (16, 36, True)),
    # dense in another order of the dims: a channel is a dim's stride
    'transposed': (lambda: (_x((4, 6)).t(), _scale(()), 8), (1, 1, False)),
    'channels_last_3d': (lambda: (_x((4, 6, 5)).permute(0, 2, 1), _scale(()), 8), (1, 1, False)),
    'per_channel_dim0_channels_last': (
        lambda: (_x((16, 4, 3, 3), fmt=CL), _scale((16, 1, 1, 1)), 8), (16, 36, True)),
    'per_row_channels_last': (
        lambda: (_x((2, 6, 4, 5), fmt=CL), _scale((1, 1, 4, 1)), 8), (4, 30, True)),
    'per_channel_permuted_3d': (
        lambda: (_x((4, 5, 6)).permute(0, 2, 1), _scale((1, 6, 1)), 8), (6, 1, True)),
    'per_channel_too_many': (lambda: (_x((1, 5000)), _scale((1, 5000)), 8), (5000, 1, True)),
    'empty': (lambda: (_x((0, 3)), _scale(()), 8), (1, 1, False)),
    # what the kernel does not read
    'float16': (lambda: (_x((2, 3), torch.float16), _scale(()), 8), None),
    'float64': (lambda: (_x((2, 3), torch.float64), _scale(()), 8), None),
    'int8_codes': (lambda: (torch.zeros((2, 3), dtype=torch.int8), _scale(()), 8), None),
    'scale_float64': (lambda: (_x((2, 3)), _scale((), torch.float64), 8), None),
    'scale_python_float': (lambda: (_x((2, 3)), 0.05, 8), None),
    'strided_view': (lambda: (_x((2, 3, 8, 5))[:, :, ::2], _scale(()), 8), None),
    'scale_grows_x': (lambda: (_x((2, 3)), _scale((1, 1, 1)), 8), None),
    'per_channel_flat_vector': (lambda: (_x((2, 6, 4, 6)), _scale((6,)), 8), None),
    'per_channel_not_adjacent': (
        lambda: (_x((2, 6, 4, 5), fmt=CL), _scale((12,))[::2].view(1, -1, 1, 1), 8), None),
    'per_channel_two_dims': (lambda: (_x((2, 6, 4, 5)), _scale((1, 6, 4, 1)), 8), None),
    'sixteen_bits': (lambda: (_x((2, 3)), _scale(()), 16), None),
}


@pytest.mark.parametrize('case', list(LAYOUTS))
def test_codes_layout_by_case(case):
    """What the codes kernel would read, from dtype, layout, the scale's
    shape and the bits alone; on the CPU no route to the kernel."""
    make, want = LAYOUTS[case]
    x, scale, bits = make()
    assert im.codes_layout(x, scale, bits) == want
    assert im.codes_route(x, scale, bits) is None


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('per_channel', [False, True], ids=['scalar', 'per_channel'])
def test_cpu_runs_the_plain_twin_and_counts_no_launch(dtype, per_channel):
    """On the CPU ``quantize_sym_codes`` is the plain composition, values at
    ties and past the grid included, and moves neither counter."""
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn((2, 8, 5, 3), generator=gen) * 20).to(dtype).contiguous(memory_format=CL)
    x.as_strided((x.numel(),), (1,))[:6] = torch.tensor(
        [2.5, -3.5, 127.5, -128.0, float('inf'), -0.0]).to(dtype)
    scale = (torch.rand(8, generator=gen) + 0.5).view(1, -1, 1, 1) if per_channel \
        else torch.tensor(1.0)
    before = counters.snapshot()
    got = im.quantize_sym_codes(x, scale, 8)
    assert counters.since(before) == {}
    assert got.dtype == torch.int8 and torch.equal(got, im.quantize_sym_codes_plain(x, scale, 8))
    if not per_channel:
        assert got.as_strided((6,), (1,)).tolist() == [2, -4, 127, -127, 127, 0]


def _specials(bits, scale, dtype):
    """Values at k + 0.5 ties of the grid, at +-qmax +- 0.5 and beyond, +-inf,
    NaN, -0.0, denormals and 1e30: in grid units times ``scale``, and raw."""
    q = 2 ** (bits - 1) - 1
    grid = [k + 0.5 for k in range(-q - 2, q + 2)] + [q - 0.5, q + 0.5, -q - 0.5, -q + 0.5,
                                                     q + 1, -q - 1, 3 * q]
    raw = [float('inf'), float('-inf'), float('nan'), -0.0, 0.0, 1e-40, -1e-45, 1.2e-38, 1e30,
           -1e30, 3.4e38]
    return (torch.tensor(grid, dtype=torch.float32) * scale).to(dtype), \
        torch.tensor(raw, dtype=torch.float32).to(dtype)


def _plant(x, values, gen):
    """``values`` (as many as ``x`` holds) written at random places of ``x``'s
    memory."""
    flat = x.as_strided((x.numel(),), (1,))
    k = min(x.numel(), values.numel())
    at = torch.randperm(x.numel(), generator=gen)[:k]
    flat[at.to(x.device)] = values[torch.randperm(values.numel(), generator=gen)[:k]].to(x.device)


# (shape, memory format, per-channel scale, dtype, bits, offset into a larger
# buffer in elements): the serving models' largest entries at their cells'
# batches (Inception-v3's Conv2d_2a input at 299x299, MobileNet-v2's widest
# depthwise input, ResNet-50's stem output at batch 256), then small and
# ragged cases in every layout
CARD_CASES = [
    ((128, 32, 149, 149), CL, False, torch.float32, 8, 0),
    ((128, 96, 112, 112), CL, True, torch.float32, 8, 0),
    ((256, 64, 112, 112), CL, False, torch.float32, 8, 0),
    ((3, 5, 7, 11), CL, True, torch.float32, 8, 1),
    ((3, 5, 7, 11), torch.contiguous_format, True, torch.float32, 4, 3),
    ((3, 5, 7, 11), torch.contiguous_format, False, torch.float32, 8, 2),
    ((2, 960, 7, 7), CL, True, torch.float32, 8, 0),
    ((2, 960, 7, 7), CL, True, torch.float32, 4, 0),
    ((4, 2048), torch.contiguous_format, False, torch.float32, 8, 0),
    ((5, 33, 9, 9), CL, False, torch.bfloat16, 8, 1),
    ((5, 33, 9, 9), CL, True, torch.bfloat16, 4, 3),
    ((5, 33, 9, 9), torch.contiguous_format, True, torch.bfloat16, 8, 0),
    ((13,), torch.contiguous_format, False, torch.float32, 8, 1),
    ((2,), torch.contiguous_format, False, torch.bfloat16, 8, 1),
    ((6, 5000), torch.contiguous_format, True, torch.float32, 8, 1),
]


@pytest.mark.cuda
def test_codes_kernel_equals_plain_on_card():
    """The codes kernel against the plain composition, bit for bit, over the
    cases above, each with every special value planted in it: the codes
    equal, in ``x``'s layout, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    gen = torch.Generator().manual_seed(7)
    for shape, fmt, per_channel, dtype, bits, offset in CARD_CASES:
        n = 1
        for s in shape:
            n *= s
        c = shape[1] if len(shape) > 1 else 1
        if per_channel:
            scale = (torch.rand(c, generator=gen) * 0.09 + 0.01)
            scale[0], scale[-1] = 2.0 ** -3, 1e-8
            scale = scale.cuda().view(1, -1, *([1] * (len(shape) - 2)))
        else:
            scale = torch.tensor(2.0 ** -3 if offset % 2 else 0.0137).cuda()
        buf = torch.empty(n + offset, dtype=torch.float32, device='cuda').normal_(
            generator=torch.Generator('cuda').manual_seed(n)).mul_(0.01 * 2 ** (bits - 1))
        base = buf.to(dtype)[offset:]
        if fmt == CL:
            dims = (shape[0], shape[2], shape[3], shape[1])
            x = base.view(dims).permute(0, 3, 1, 2)
        else:
            x = base.view(shape)
        grid, raw = _specials(bits, float(scale.reshape(-1)[0]), dtype)
        _plant(x, torch.cat([grid, raw]), gen)
        layout = im.codes_route(x, scale, bits)
        assert layout is not None and layout[2] == per_channel, (shape, fmt, dtype)
        before = counters.snapshot()
        got = im.quantize_sym_codes(x, scale, bits)
        counts = counters.since(before)
        want = im.quantize_sym_codes_plain(x, scale, bits)
        what = (shape, str(fmt), per_channel, str(dtype), bits, offset)
        assert counts == {'quantize_codes.launches': 1}, what
        assert got.dtype == torch.int8 and got.shape == x.shape and got.stride() == x.stride(), what
        assert torch.equal(got, want), (what, int((got != want).sum()))
        del buf, base, x, got, want


@pytest.mark.cuda
def test_codes_kernel_takes_the_call_or_raises_on_card():
    """No CUDA call runs the plain composition.  A strided view (copied
    dense), a permuted tensor, a weight's per-output-channel scale in
    channels_last memory and more per-channel scales than the kernel holds in
    shared memory each take one launch, equal to the plain composition bit
    for bit; every call the kernel does not read raises."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    gen = torch.Generator('cuda').manual_seed(5)
    x = torch.randn((4, 6, 8, 10), device='cuda', generator=gen) * 3
    s = torch.tensor(0.0137, device='cuda')
    w = torch.randn((16, 4, 3, 3), device='cuda', generator=gen).contiguous(memory_format=CL)
    w_s = w.abs().amax(dim=(1, 2, 3), keepdim=True) / 127
    wide = torch.randn((3, 5000), device='cuda', generator=gen)
    wide_s = torch.rand((1, 5000), device='cuda', generator=gen) * 0.02 + 0.001
    for xx, ss in ((x[:, :, ::2], s), (x.transpose(1, 3), s), (w, w_s), (wide, wide_s)):
        before = counters.snapshot()
        got = im.quantize_sym_codes(xx, ss)
        assert counters.since(before) == {'quantize_codes.launches': 1}, tuple(xx.shape)
        assert torch.equal(got, im.quantize_sym_codes_plain(xx, ss)), tuple(xx.shape)
    for xx, ss, bits in ((x.half(), s, 8), (x.double(), s, 8), (x, s.cpu(), 8), (x, 0.05, 8),
                         (x, s.double(), 8), (x, s, 16), (x, s.view(1, 1, 1, 1, 1), 8),
                         (x, torch.full((1, 6, 8, 1), 0.05, device='cuda'), 8)):
        before = counters.snapshot()
        with pytest.raises(ValueError, match='codes kernel takes'):
            im.quantize_sym_codes(xx, ss, bits)
        assert counters.since(before) == {}
