"""Experiment CLI, flag-compatible with ``cnn_quantization_tpu/cli/
inference_sim.py`` (reference inference/inference_sim.py:52-112).

This slice runs the simulation path of the README's ResNet commands:

  # W4A4 naive
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 512 \\
      -pcq_w -pcq_a -sh --qtype int4 -qw int4 --weights resnet50.pth
  # headline recipe
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 512 \\
      -pcq_w -pcq_a -sh --qtype int4 -qw int4 -c laplace -baa -baw -bcw
  # offline statistics: collect, then evaluate with frozen qparams
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 1 \\
      --qtype int8 -sm collect -ac -cs 32
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 512 \\
      -pcq_w -pcq_a --qtype int4 -qw int4 -c laplace -baa -baw -bcw -sm use

  # true-int8 serving: prepared int8 weights, frozen activation scales
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \\
      --qtype int8 -qw int8 --serving_int8 [--serving_cal aciq] [--serving_s2d_stem]
  # W4A4 packed serving: the Bottleneck trunk's 1x1 convs as int4-packed GEMMs
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \\
      --qtype int4 -qw int4 --serving_int8 --serving_packed [--serving_packed_stages 1,3]

plus ``--device`` (the card unless ``cpu``), ``--input_size``, ``--subset``
and ``--seed``.  Data is synthetic (``data/synthetic.py``).  The parser keeps
every flag of the JAX CLI; each flag outside this slice exits with a message
naming its ROADMAP item, so no flag is ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_LATER_CLI = 'Queue 1 item 14 (the rest of the inference_sim flags)'
# dest -> the ROADMAP item that ports it; each such flag defaults to None
_UNPORTED = {
    'workers': 'Queue 1 item 13 (ImageNet loader)',
    'print_freq': _LATER_CLI,
    'dtype': _LATER_CLI,
    'q_off': _LATER_CLI,
    'stochastic': _LATER_CLI,
    'eval_precision': _LATER_CLI,
    'rho_act': _LATER_CLI,
    'rho_weight': _LATER_CLI,
    'stats_kind': _LATER_CLI,
    'stats_folder': _LATER_CLI,
    'stats_batch_avg': _LATER_CLI,
    'custom_test': _LATER_CLI,
    'order_file': _LATER_CLI,
    'dump_dir': _LATER_CLI,
    'measure_stats': _LATER_CLI,
    'mlf_experiment': _LATER_CLI,
    'kld_threshold': 'Queue 1 item 8 (KLD calibration)',
    'bit_alloc_rmode': _LATER_CLI,
    'bit_alloc_prior': _LATER_CLI,
    'bit_alloc_target_act': _LATER_CLI,
    'bit_alloc_target_weight': _LATER_CLI,
    'bias_corr_act': _LATER_CLI,
    'var_corr_weight': _LATER_CLI,
    'measure_entropy': _LATER_CLI,
    'mid_thread_quant': 'Queue 1 item 12 (mid-tread quantization)',
    'mesh_data': 'Queue 1 item 9 (parallel layer)',
    'mesh_model': 'Queue 1 item 9 (parallel layer)',
}


def build_parser():
    p = argparse.ArgumentParser(description='Quantized-inference simulator (PyTorch/CUDA)')
    p.add_argument('--data', metavar='DIR', default=os.environ.get('IMAGENET_DIR'),
                   help='path to ImageNet; this slice runs synthetic data and exits '
                        'if the path exists (the ImageNet loader is not ported)')
    p.add_argument('--arch', '-a', default='resnet18')
    p.add_argument('--weights', '-w', default=None,
                   help='torchvision .pth state dict (BN folded at load)')
    p.add_argument('-b', '--batch-size', default=256, type=int)
    p.add_argument('--seed', default=None, type=int,
                   help='weight-init seed (default 0) and synthetic-data seed '
                        '(default 12345)')
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    p.add_argument('--input_size', default=None, type=int,
                   help='override the input crop size (default 224)')
    p.add_argument('--qtype', default=None, help='data type: int[N]')
    p.add_argument('--qweight', '-qw', default='int8')
    p.add_argument('--serving_int8', '-si8', action='store_true',
                   help='true-integer deployment path: int8 convs and GEMMs with '
                        'frozen activation scales (bit widths from --qtype/--qweight, '
                        'clamped to the int8 grid)')
    p.add_argument('--serving_cal', default='max', choices=('max', 'percentile', 'aciq'),
                   help='serving scale calibration: abs-max, |x| percentile, or '
                        'ACIQ-Laplace optimal clip')
    p.add_argument('--serving_percentile', default=99.99, type=float,
                   help='percentile for --serving_cal percentile (any value, used exactly)')
    p.add_argument('--serving_s2d_stem', action='store_true',
                   help='space-to-depth int8 stem rewrite (opt-in)')
    p.add_argument('--serving_packed', action='store_true',
                   help='with --serving_int8 at 4-bit activations on a Bottleneck ResNet: '
                        'run the 1x1 convs as int4-packed GEMMs, block boundaries two '
                        'codes to a byte')
    p.add_argument('--serving_packed_stages', default=None,
                   help='with --serving_packed: comma-separated 1-based stages to pack '
                        '(e.g. 1,3); the others stay on the plain int8 path')
    p.add_argument('--shuffle', '-sh', action='store_true',
                   help='shuffle the evaluation images (seeded)')
    p.add_argument('--clipping', '-c', default='no',
                   help='[no, gaus, laplace, exp, <p>std, mix]')
    p.add_argument('--stats_mode', '-sm', default='no', choices=('collect', 'use', 'no'))
    p.add_argument('--aciq_cal', '-ac', action='store_true', default=False,
                   help='collect on the first --cal_set_size images only')
    p.add_argument('--cal_set_size', '-cs', default=5120, type=int)
    p.add_argument('--subset', '-ss', default=None, type=int)
    p.add_argument('--per_channel_quant_weights', '-pcq_w', action='store_true')
    p.add_argument('--per_channel_quant_act', '-pcq_a', action='store_true')
    p.add_argument('--bit_alloc_act', '-baa', action='store_true')
    p.add_argument('--bit_alloc_weight', '-baw', action='store_true')
    p.add_argument('--bias_corr_weight', '-bcw', action='store_true')

    later = 'not ported yet (exits naming its ROADMAP item)'
    for flags, kw in (
            (('-j', '--workers'), dict(type=int)),
            (('--print-freq', '-p'), dict(type=int)),
            (('--dtype',), {}),
            (('--q_off',), dict(action='store_true')),
            (('--stochastic', '-s'), dict(action='store_true')),
            (('--eval_precision', '-ep'), dict(action='store_true')),
            (('--rho_act', '-ra'), dict(type=float)),
            (('--rho_weight', '-rw'), dict(type=float)),
            (('--stats_kind', '-sk'), {}),
            (('--stats_folder', '-sf'), {}),
            (('--stats_batch_avg', '-sba'), dict(action='store_true')),
            (('--custom_test', '-ct'), dict(action='store_true')),
            (('--order_file',), {}),
            (('--dump_dir', '-dd'), {}),
            (('--measure_stats', '-ms'), dict(action='store_true')),
            (('--mlf_experiment', '-mlexp'), {}),
            (('--kld_threshold', '-kld'), dict(action='store_true')),
            (('--bit_alloc_rmode', '-bam'), {}),
            (('--bit_alloc_prior', '-bap'), {}),
            (('--bit_alloc_target_act', '-bata'), dict(type=float)),
            (('--bit_alloc_target_weight', '-batw'), dict(type=float)),
            (('--bias_corr_act', '-bca'), dict(action='store_true')),
            (('--var_corr_weight', '-vcw'), dict(action='store_true')),
            (('--measure_entropy', '-me'), dict(action='store_true')),
            (('--mid_thread_quant', '-mtq'), dict(action='store_true')),
            (('--mesh_data',), dict(type=int)),
            (('--mesh_model',), dict(type=int))):
        p.add_argument(*flags, default=None, help=later, **kw)
    return p


def _reject_unported(args):
    for dest, item in _UNPORTED.items():
        if getattr(args, dest) is not None:
            raise SystemExit(f"--{dest} is not ported to the PyTorch/CUDA package yet: "
                             f'ROADMAP {item}')
    if args.data and os.path.exists(args.data):
        raise SystemExit(f'--data {args.data}: the ImageNet loader is not ported yet '
                         '(ROADMAP Queue 1 item 13); omit --data for synthetic data')
    if args.weights and not args.weights.endswith(('.pth', '.pt')):
        raise SystemExit(f'--weights {args.weights}: only torchvision .pth/.pt '
                         f'checkpoints load in this slice (ROADMAP {_LATER_CLI})')


def packed_from_args(args):
    """``packed`` for ``make_forward``: False, True, or the tuple of stages of
    ``--serving_packed_stages``.  Unlike the JAX CLI, which ignores them, a
    stage list without ``--serving_packed`` and an empty one are refused."""
    stages = args.serving_packed_stages
    if args.serving_packed and not args.serving_int8:
        raise SystemExit('--serving_packed needs --serving_int8')
    if stages is None:
        return args.serving_packed
    if not args.serving_packed:
        raise SystemExit('--serving_packed_stages needs --serving_packed')
    try:
        picked = tuple(int(s) for s in stages.split(',') if s.strip())
    except ValueError:
        picked = ()
    if not picked or any(not 1 <= s <= 4 for s in picked):
        raise SystemExit(f'--serving_packed_stages must list stages 1-4, got {stages!r}')
    return picked


def policy_from_args(args):
    from ..engine import QuantPolicy
    return QuantPolicy(
        qtype=args.qtype, qweight=args.qweight, clipping=args.clipping,
        pcq_weights=args.per_channel_quant_weights,
        pcq_act=args.per_channel_quant_act,
        bit_alloc_act=args.bit_alloc_act, bit_alloc_weight=args.bit_alloc_weight,
        bias_corr_weight=args.bias_corr_weight, arch=args.arch)


def load_params(args, model):
    if args.weights:
        from ..utils.checkpoint import load_folded_state_dict
        device = next(model.parameters()).device
        model.load_state_dict(load_folded_state_dict(args.weights, device))
    else:
        print(f'=> no weights given; random init for {args.arch} '
              '(accuracy numbers will be meaningless)')
    return dict(model.state_dict())


def synthetic_loader(args, size: int):
    """The JAX CLI's synthetic fallback (data/imagenet.py make_loader): 8
    batches, or ``subset // batch`` of them; ``-sh`` permutes the images."""
    from ..data.synthetic import synthetic_batches
    bs = args.batch_size
    n = 8 if args.subset is None else max(1, args.subset // bs)
    seed = args.seed or 12345
    batches = list(synthetic_batches(bs, n, size=size, seed=seed))
    if not args.shuffle:
        return batches
    images = np.concatenate([b[0] for b in batches])
    labels = np.concatenate([b[1] for b in batches])
    perm = np.random.RandomState(seed).permutation(len(images))
    images, labels = images[perm], labels[perm]
    return [(images[i:i + bs], labels[i:i + bs]) for i in range(0, len(images), bs)]


def _s2d_stem_applied(params_s) -> bool:
    """True if ``prepare_serving_params`` space-to-depth transformed the stem
    kernel (an int8 [O, 12, 4, 4] weight exists in the tree)."""
    return any(getattr(v, 'ndim', 0) == 4 and tuple(v.shape[1:]) == (12, 4, 4)
               for v in params_s.values())


def main(argv=None):
    args = build_parser().parse_args(argv)
    _reject_unported(args)
    packed = packed_from_args(args)

    from ..calib.calibrator import (collect_statistics, default_stats_path,
                                    load_stats, save_stats)
    from ..engine import QuantEngine
    from ..engine.evaluate import evaluate
    from ..engine.policy import parse_qtype_bits
    from ..models import build_model
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"=> building model '{args.arch}' on {device}")
    model, meta = build_model(args.arch, device=device, seed=args.seed or 0)
    params = load_params(args, model)
    policy = policy_from_args(args)
    size = args.input_size or meta.input_size

    stats_path = default_stats_path(args.arch, per_channel=args.per_channel_quant_act)
    loader = synthetic_loader(args, size)
    print('=> ImageNet not found; using synthetic data')
    engine = QuantEngine(model, policy, meta)

    if args.stats_mode == 'collect':
        print('Collecting statistics...')
        err_bits = parse_qtype_bits(args.qtype) if args.qtype else None
        summary = collect_statistics(
            engine.make_collect(err_bits=err_bits), params, loader,
            cal_set_size=args.cal_set_size if args.aciq_cal else None)
        save_stats(stats_path, summary)
        print(f'Saved statistics for {len(summary)} sites -> {stats_path}')
        return 0

    stats = qparams = None
    if args.stats_mode == 'use':
        if not os.path.exists(stats_path):
            raise SystemExit(f'no stats at {stats_path}; run -sm collect')
        stats = load_stats(stats_path)
        print(f'Loaded statistics for {len(stats)} sites from {stats_path}')
        if policy.qtype is not None:
            qparams = engine.freeze_qparams(stats, input_shape=(1, size, size, 3))
            print(f'Froze qparams for {len(qparams)} sites')

    params_q = engine.quantize_params(params)
    if args.serving_int8:
        print(f'=> serving-int8: calibrating frozen activation scales ({args.serving_cal})')
        # the s2d stem is opt-in and needs an even input size
        params_s = engine.prepare_serving_params(
            params_q, s2d_stem=args.serving_s2d_stem and size % 2 == 0)
        if args.serving_s2d_stem and not _s2d_stem_applied(params_s):
            why = 'odd input size' if size % 2 else 'stem is not a BN-folded 7x7x3 conv'
            print(f'=> note: --serving_s2d_stem requested but not applied ({why}); '
                  'stem runs as the float conv')
        scales = engine.freeze_serving_scales(params_s, loader, mode=args.serving_cal,
                                              percentile=args.serving_percentile,
                                              packed=args.serving_packed)
        res = evaluate(engine, params_s, loader, stats=stats, quantized='serving_int8',
                       act_scales=scales, packed=packed, subset=args.subset, verbose=True)
    else:
        res = evaluate(engine, params_q if policy.qtype else params, loader,
                       stats=stats, quantized=policy.qtype is not None,
                       subset=args.subset, verbose=True, qparams=qparams)
    print(f" * Prec@1 {res['top1']:.3f} Prec@5 {res['top5']:.3f} "
          f"({res['images_per_sec']:.1f} img/s on {device})")
    print(json.dumps({k: round(float(v), 4) for k, v in res.items()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
