"""The rest of the zoo in the port's registry against the JAX package's, by
structure: for each of the 15 architectures beyond the ResNet family and
MobileNet-v2, the site table (id, tag, half-range mark, kind, shape) equals
the JAX package's ``discover_sites`` at a small input, the parameter count
equals JAX's (and torchvision's where ``tests/test_models.py`` pins it), and
the weight bridge carries JAX's whole parameter tree onto the port model's
state dict, key for key and shape for shape.  The models here are built on
the ``meta`` device (nothing allocated, nothing initialised), as the deep
ResNet variants are in ``tests/test_torch_zoo.py``.  Two traps of the bridge
have a test each: Inception-v3's own ``branch5x5_1`` names must not split,
and VGG's feature map must be flattened in the JAX package's (H, W, C) order
(``tests/test_torch_zoo_vgg.py``)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine import TapContext as JTapContext
from cnn_quantization_tpu.engine.qparams import RecordingContext as JRecordingContext
from cnn_quantization_tpu.models import available_archs as j_available_archs
from cnn_quantization_tpu.models import build_model as j_build_model

from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import available_archs, build_model
from cnn_quantization_tpu_torch.models import zoo
from cnn_quantization_tpu_torch.utils.flax_params import state_dict_from_flax

from _torch_parity import site_table

# the input each is compared at: the JAX tests' small sizes or smaller (VGG
# pools five times, AlexNet's stem strides by 4, Inception-v3 needs 75)
SIZES = {'vgg11': 32, 'vgg13': 32, 'vgg16': 32, 'vgg19': 32, 'vgg16_bn': 64, 'alexnet': 96,
         'squeezenet1_0': 64, 'squeezenet1_1': 64, 'inception_v3': 75, 'densenet121': 32,
         'densenet161': 32, 'densenet169': 32, 'densenet201': 32, 'googlenet': 64,
         'shufflenet': 32}
# parameter counts (millions) that tests/test_models.py pins to torchvision's
TORCHVISION_MPARAMS = {'alexnet': 61.10, 'squeezenet1_0': 1.25, 'squeezenet1_1': 1.24}


@pytest.fixture(scope='module', params=sorted(SIZES))
def both(request):
    """(arch, size, JAX sites, JAX eval_shape params, port model on meta).
    One abstract trace gives both JAX results: ``discover_sites``' own
    (init, then apply with its recording context), keeping the params."""
    arch = request.param
    size = SIZES[arch]
    j_model, j_meta = j_build_model(arch)
    ctx = JRecordingContext()

    def init_apply(k, x):
        variables = j_model.init(k, x, JTapContext())
        j_model.apply(variables, x, ctx)
        return variables['params']

    j_params = jax.eval_shape(init_apply, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    with torch.device('meta'):
        model = zoo._build(arch, j_meta.fold_bn, 1000, torch.float32, size)
    return arch, size, ctx.sites, j_params, model


def test_site_table_equals_jax(both):
    arch, size, j_sites, _, model = both
    want = site_table(j_sites, nhwc=True)
    got = site_table(discover_sites(model, (1, 3, size, size)), nhwc=False)
    assert got == want
    assert not any(hr for _, _, hr, _, _ in got)   # no 'resnet' arch: nothing marked


def test_parameter_count_equals_jax(both):
    arch, _, _, j_params, model = both
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(j_params))
    assert sum(v.numel() for v in model.state_dict().values()) == want


def test_bridge_covers_the_whole_tree(both):
    """Every JAX leaf lands on a port state-dict entry of the same shape, and
    every entry of the port's state dict is reached."""
    arch, _, _, j_params, model = both
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), j_params)
    got = {k: tuple(v.shape) for k, v in state_dict_from_flax(zeros, arch).items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


@pytest.mark.parametrize('arch', sorted(TORCHVISION_MPARAMS))
def test_parameter_count_at_224_equals_torchvision(arch):
    with torch.device('meta'):
        model = zoo._build(arch, False, 1000, torch.float32, 224)
    n = sum(v.numel() for v in model.state_dict().values())
    assert abs(n / 1e6 - TORCHVISION_MPARAMS[arch]) < 0.05, n


def test_inception_numbering_and_meta():
    """94 convs run and the ids reach conv95 (the aux tower consumes two),
    the classifier is linear1 (the aux fc took linear0); 299x299 input and
    the two 8-bit stem convs by name, as the JAX meta."""
    model, meta = build_model('inception_v3', device='meta')
    j_model, j_meta = j_build_model('inception_v3')
    assert (meta.input_size, meta.eight_bit_weight_names, meta.fold_bn) == \
        (j_meta.input_size, j_meta.eight_bit_weight_names, j_meta.fold_bn) == \
        (299, ('Conv2d_1a_3x3', 'Conv2d_2a_3x3'), True)
    sites = discover_sites(model, (1, 3, 299, 299))
    convs = sorted(int(s.id[4:].split('_')[0]) for s, _ in sites if s.id.startswith('conv'))
    assert len(convs) == 94 and convs[-1] == 95
    assert [s.id for s, _ in sites if s.id.startswith('linear')] == ['linear1_activation']
    assert [s.tag for s, _ in sites if s.id == 'linear1_activation'] == ['activation_classifier']
    names = [n for n, m in model.named_modules() if n.endswith(('Conv2d_1a_3x3.conv',
                                                                'Conv2d_2a_3x3.conv'))]
    assert names == ['Conv2d_1a_3x3.conv', 'Conv2d_2a_3x3.conv']


def test_inception_branch_names_are_not_split():
    """torchvision's Inception-v3 names end in ``_<digits>`` themselves
    (``branch5x5_1``): split as a merged numeric segment they would become
    ``branch5x5.1``, which no module of the port (or of torchvision) has."""
    tree = {'Mixed_5b': {'branch5x5_1': {'conv': {'kernel': np.zeros((1, 1, 192, 48), np.float32),
                                                  'bias': np.zeros(48, np.float32)}}},
            'Mixed_7a': {'branch7x7x3_4': {'conv': {'kernel': np.zeros((3, 3, 192, 192),
                                                                       np.float32)}}}}
    got = state_dict_from_flax(tree, 'inception_v3')
    assert sorted(got) == ['Mixed_5b.branch5x5_1.conv.bias', 'Mixed_5b.branch5x5_1.conv.weight',
                           'Mixed_7a.branch7x7x3_4.conv.weight']
    model, _ = build_model('inception_v3', device='meta')
    assert set(got) <= set(model.state_dict())
    # the ResNet-style merged segments still split for every other arch
    assert sorted(state_dict_from_flax({'features_10': tree['Mixed_7a']['branch7x7x3_4']},
                                       'vgg16')) == ['features.10.conv.weight']


def test_googlenet_branch_names_split():
    model, _ = build_model('googlenet', device='meta')
    keys = set(model.state_dict())
    assert 'inception3a.branch2.0.conv.weight' in keys and 'inception5b.branch4.1.bn.var' \
        not in keys and 'inception5b.branch4.1.bn.running_var' in keys
    tree = {'inception3a': {'branch2_0': {'conv': {'kernel': np.zeros((1, 1, 192, 96),
                                                                      np.float32)}}}}
    assert list(state_dict_from_flax(tree, 'googlenet')) == ['inception3a.branch2.0.conv.weight']


def test_registry_equals_jax_and_builds_every_arch():
    assert available_archs() == j_available_archs()
    for arch in available_archs():
        model, meta = build_model(arch, device='meta')
        assert meta.arch == arch and meta.fold_bn == j_build_model(arch)[1].fold_bn
    assert build_model('mobilenetv2', device='meta')[1].arch == 'mobilenet_v2'


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch 'resnet9'") as err:
        build_model('resnet9', device='cpu')
    assert all(a in str(err.value) for a in available_archs())
    assert 'item 7' not in str(err.value)


# the zoo's pools, at odd and even sizes: (window, stride, padding, ceil_mode)
POOLS = {'squeezenet_ceil': (3, 2, 0, True), 'googlenet_branch_ceil': (3, 1, 1, True),
         'googlenet_maxpool4_ceil': (2, 2, 0, True), 'densenet_pool0': (3, 2, 1, False),
         'vgg': (2, 2, 0, False)}


@pytest.mark.parametrize('size', [7, 8, 13, 54, 55])
@pytest.mark.parametrize('pool', sorted(POOLS))
def test_max_pool_matches_jax(pool, size):
    """``QMaxPool`` against the JAX layer, whose ceil_mode pads the high side
    by its own formula (torch adds a rule of its own for windows that would
    start in the padding; neither applies to a different result here)."""
    from cnn_quantization_tpu.models.layers import QMaxPool as JQMaxPool
    from cnn_quantization_tpu_torch.engine import TapContext
    from cnn_quantization_tpu_torch.models.layers import QMaxPool
    w, s, p, ceil = POOLS[pool]
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(JQMaxPool(w, s, p, ceil_mode=ceil).apply({}, jnp.asarray(x), JTapContext()))
    got = QMaxPool(w, s, p, ceil_mode=ceil)(torch.from_numpy(x).permute(0, 3, 1, 2),
                                            TapContext())
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('size', [7, 8, 55])
@pytest.mark.parametrize('window,stride,padding', [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_avg_pool_matches_jax(window, stride, padding, size):
    """``QAvgPool`` (ShuffleNet's 3x3/2 shortcut with padding, DenseNet's
    transitions) and Inception's functional 3x3/1 branch pool against JAX:
    the padding counted in the divisor."""
    from cnn_quantization_tpu.models.inception import _avg_pool as j_avg_pool
    from cnn_quantization_tpu.models.layers import QAvgPool as JQAvgPool
    from cnn_quantization_tpu_torch.engine import TapContext
    from cnn_quantization_tpu_torch.models.inception import _avg_pool
    from cnn_quantization_tpu_torch.models.layers import QAvgPool
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(JQAvgPool(window, stride, padding).apply({}, jnp.asarray(x), JTapContext()))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = QAvgPool(window, stride, padding)(xt, TapContext())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    if (window, stride, padding) == (3, 1, 1):
        np.testing.assert_allclose(_avg_pool(xt).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j_avg_pool(jnp.asarray(x), 3, 1, 1)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('arch,size', [('inception_v3', 75), ('googlenet', 64),
                                       ('densenet121', 32), ('squeezenet1_1', 64),
                                       ('shufflenet', 32)])
def test_int8_conv_inputs_stay_channels_last(arch, size):
    """The concatenations (Inception, GoogLeNet, DenseNet, SqueezeNet) and the
    channel shuffle hand every integer conv a channels_last input, so no
    hidden copy lands ahead of the int8 kernels on the serving path."""
    from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
    from cnn_quantization_tpu_torch.models.layers import QConv
    model, meta = build_model(arch, device='cpu', input_size=size)
    layouts, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, QConv) and m.in_ch != 3:
            hooks.append(m.register_forward_pre_hook(
                lambda _m, args, name=name: layouts.__setitem__(
                    name, args[0].is_contiguous(memory_format=torch.channels_last))))
    eng = QuantEngine(model, QuantPolicy(arch=arch, qtype='int8', qweight='int8'), meta)
    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng.make_forward(quantized='serving_int8')(
            eng.prepare_serving_params(dict(model.state_dict())), None, x)
    finally:
        torch.set_num_threads(n)
        for h in hooks:
            h.remove()
    assert len(layouts) == len(hooks) and all(layouts.values()), \
        [k for k, v in layouts.items() if not v]
