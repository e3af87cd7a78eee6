"""Experiment CLI, flag-compatible with ``cnn_quantization_tpu/cli/
inference_sim.py`` (reference inference/inference_sim.py:52-112).

It runs every architecture of the registry (``models.available_archs()``,
the JAX package's 25 names; the input size is the arch's, 299 for
inception_v3), for example the README's commands:

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

  # KLD (TensorRT entropy) calibration: collect thresholds, then use them
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 8 \\
      --qtype int4 -sm collect -kld -cs 16
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \\
      --qtype int4 -qw int4 -pcq_w -sm use -kld
  # mid-tread quantization with bit allocation, measuring the code entropy
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \\
      -mtq -c laplace -pcq_w -pcq_a -baa -baw -me --qtype int4 -qw int4
  # sweeps: precision (fp32, int8..int4) and layer sensitivity
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -ep -c laplace
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 --qtype int4 \\
      -ct --order_file order.json
  # the rest of the zoo: VGG-16 mid-tread at a 5.3-bit allocation target,
  # Inception-v3 on W8A8 serving
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a vgg16 -b 32 -pcq_w -pcq_a \\
      --qtype int4 -qw int4 -c laplace -baa -baw -bcw -bata 5.3 -batw 5.3 -mtq -me
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a inception_v3 -b 32 \\
      --qtype int8 -qw int8 --serving_int8

  # real data: a preprocessed .npz (no decoder needed) or a class-folder tree
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \
      -pcq_w -pcq_a --qtype int4 -qw int4 -c laplace -baa -baw -bcw --data val.npz
  python -m cnn_quantization_tpu_torch.cli.inference_sim -a resnet50 -b 64 \
      --qtype int8 -qw int8 --serving_int8 --data ~/datasets/ILSVRC2012 -j 8
  # data and tensor parallel over torch.distributed (NCCL on the cards)
  torchrun --nproc_per_node 4 -m cnn_quantization_tpu_torch.cli.inference_sim \
      -a resnet50 -b 256 --qtype int8 -qw int8 --serving_int8 --mesh_data 2 --mesh_model 2

plus every other flag of the JAX CLI: ``-s``, ``-ra/-rw``, ``-sk``, ``-sf``,
``-sba``, ``-bam/-bap/-bata/-batw``, ``-bca``, ``-vcw``, ``-ms``, ``-dd``,
``-mlexp``, ``--dtype``, ``--weights *.npz``, and ``--device`` (the card
unless ``cpu``).  ``--data`` reads a preprocessed ``.npz`` or a class-folder
tree (``data/imagenet.py``, decoded by ``-j`` threads; a tree needs PIL) and
falls back to synthetic batches (``data/synthetic.py``) when neither exists.
``--mesh_data``/``--mesh_model`` shard the evaluation over the ranks of a
process group (``parallel/``: launch under torchrun); a mesh larger than 1x1
without one exits, as do the packed trunk on a model axis (its int4 codes
pack along K in groups that a channel slice would cut) and the runs the
sharded path does not cover (``-sm collect -kld``, ``-ms``, ``-dd``, ``-me``;
on a data axis of more than one rank also ``-mtq`` and ``-ra``, whose
reductions are not the global batch's).  The JAX CLI parses ``-j`` and the
mesh flags and ignores them.  Where stats are loaded
(``-sm use``) the evaluations freeze every site they can
(``engine/qparams.py``); the JAX CLI quantizes from the stats on every batch.
The two agree but at a per-tensor (KLD or min/max) site whose range starts
above zero, where JAX's own frozen and dynamic forms differ (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

def build_parser():
    p = argparse.ArgumentParser(description='Quantized-inference simulator (PyTorch/CUDA)')
    p.add_argument('--data', metavar='DIR', default=os.environ.get(
        'IMAGENET_DIR', os.path.expanduser('~/datasets/ILSVRC2012')),
                   help='ImageNet: a class-folder tree (DIR or DIR/val; needs PIL) or a '
                        "preprocessed .npz ('images' [N,H,W,3] float32, 'labels'); "
                        'synthetic data if neither exists')
    p.add_argument('-j', '--workers', default=4, type=int,
                   help='decode threads of the class-folder loader')
    p.add_argument('--arch', '-a', default='resnet18',
                   help='any name of models.available_archs()')
    p.add_argument('--weights', '-w', default=None,
                   help="torchvision .pth state dict (BN folded at load where the arch "
                        "folds), or the JAX package's .npz parameter tree "
                        '(utils/checkpoint.save_params_npz)')
    p.add_argument('-b', '--batch-size', default=256, type=int)
    p.add_argument('--print-freq', '-p', default=10, type=int)
    p.add_argument('--seed', default=None, type=int,
                   help='weight-init seed (default 0) and synthetic-data seed '
                        '(default 12345)')
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    p.add_argument('--dtype', default='float32', help='compute dtype: float32|bfloat16')
    p.add_argument('--input_size', default=None, type=int,
                   help="override the input crop size (default the arch's: 299 for "
                        'inception_v3, else 224; VGG and AlexNet are built for it)')
    p.add_argument('--qtype', default=None, help='data type: int[N]')
    p.add_argument('--qweight', '-qw', default='int8')
    p.add_argument('--q_off', action='store_true', help='disable quantization')
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
                        'codes to a byte; any other arch falls back to the plain serving '
                        'path, as the JAX CLI does')
    p.add_argument('--serving_packed_stages', default=None,
                   help='with --serving_packed: comma-separated 1-based stages to pack '
                        '(e.g. 1,3); the others stay on the plain int8 path')
    p.add_argument('--shuffle', '-sh', action='store_true',
                   help='shuffle the evaluation images (real data only, as the JAX CLI: '
                        'the synthetic batches are i.i.d.)')
    p.add_argument('--stochastic', '-s', action='store_true', default=False,
                   help='stochastic rounding of activations (the fake-quant kernel\'s '
                        'stochastic mode)')
    p.add_argument('--eval_precision', '-ep', action='store_true', default=False,
                   help='sweep: fp32, then activations at int8..int4')
    p.add_argument('--clipping', '-c', default='no',
                   help='[no, gaus, laplace, exp, <p>std, mix]')
    p.add_argument('--rho_act', '-ra', default=None, type=float,
                   help='fp32 statistical clip on activations before quantization')
    p.add_argument('--rho_weight', '-rw', default=None, type=float,
                   help='fp32 ratio clip on weights before quantization')
    p.add_argument('--stats_mode', '-sm', default='no', choices=('collect', 'use', 'no'))
    p.add_argument('--stats_kind', '-sk', default='mean', help='[mean, max]')
    p.add_argument('--stats_folder', '-sf', default=None,
                   help='stats artifact name (default: the arch)')
    p.add_argument('--stats_batch_avg', '-sba', action='store_true')
    p.add_argument('--custom_test', '-ct', action='store_true', default=False,
                   help='layer-sensitivity sweep: 8-bit layers added one by one')
    p.add_argument('--order_file', default=None,
                   help='custom_test layer ordering (json list); default: derived from '
                        'calibration stats')
    p.add_argument('--dump_dir', '-dd', default=None)
    p.add_argument('--measure_stats', '-ms', action='store_true', default=False,
                   help='measure per-layer float-vs-quantized error stats')
    p.add_argument('--mlf_experiment', '-mlexp', default=None)
    p.add_argument('--kld_threshold', '-kld', action='store_true', default=False)
    p.add_argument('--aciq_cal', '-ac', action='store_true', default=False,
                   help='collect on the first --cal_set_size images only')
    p.add_argument('--cal_set_size', '-cs', default=5120, type=int)
    p.add_argument('--subset', '-ss', default=None, type=int)
    p.add_argument('--per_channel_quant_weights', '-pcq_w', action='store_true')
    p.add_argument('--per_channel_quant_act', '-pcq_a', action='store_true')
    p.add_argument('--bit_alloc_act', '-baa', action='store_true')
    p.add_argument('--bit_alloc_weight', '-baw', action='store_true')
    p.add_argument('--bit_alloc_rmode', '-bam', default='round')
    p.add_argument('--bit_alloc_prior', '-bap', default='gaus')
    p.add_argument('--bit_alloc_target_act', '-bata', type=float, default=None)
    p.add_argument('--bit_alloc_target_weight', '-batw', type=float, default=None)
    p.add_argument('--bias_corr_act', '-bca', action='store_true')
    p.add_argument('--bias_corr_weight', '-bcw', action='store_true')
    p.add_argument('--var_corr_weight', '-vcw', action='store_true')
    p.add_argument('--measure_entropy', '-me', action='store_true')
    p.add_argument('--mid_thread_quant', '-mtq', action='store_true')
    p.add_argument('--mesh_data', type=int, default=None,
                   help='data-parallel axis size (default: every rank); needs a process '
                        'group (torchrun) beyond one rank')
    p.add_argument('--mesh_model', type=int, default=1,
                   help='model (output-channel) parallel axis size')
    return p


def _check_flags(args):
    if args.weights and not args.weights.endswith(('.pth', '.pt', '.npz')):
        raise SystemExit(f'--weights {args.weights}: a torchvision .pth/.pt checkpoint or '
                         'an .npz parameter tree')
    # KLD sites quantize from the thresholds a -sm collect -kld run saved; the
    # JAX CLI fails inside the quantizer without them
    quantizes = (args.qtype and not args.q_off) or args.eval_precision
    if args.kld_threshold and args.stats_mode == 'no' and quantizes:
        raise SystemExit('-kld quantizes from the thresholds of -sm collect -kld: '
                         'run it with -sm use')


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
        stats_kind=args.stats_kind, kld=args.kld_threshold,
        pcq_weights=args.per_channel_quant_weights,
        pcq_act=args.per_channel_quant_act,
        bit_alloc_act=args.bit_alloc_act, bit_alloc_weight=args.bit_alloc_weight,
        bit_alloc_rmode=args.bit_alloc_rmode, bit_alloc_prior=args.bit_alloc_prior,
        bit_alloc_target_act=args.bit_alloc_target_act,
        bit_alloc_target_weight=args.bit_alloc_target_weight,
        bias_corr_act=args.bias_corr_act, bias_corr_weight=args.bias_corr_weight,
        var_corr_weight=args.var_corr_weight,
        measure_entropy=args.measure_entropy, mtd_quant=args.mid_thread_quant,
        stochastic=args.stochastic, rho_act=args.rho_act,
        rho_weight=args.rho_weight, arch=args.arch)


def load_params(args, model, meta):
    device = next(model.parameters()).device
    if args.weights and args.weights.endswith('.npz'):
        from ..utils.checkpoint import load_params_npz
        from ..utils.flax_params import state_dict_from_flax
        state = state_dict_from_flax(load_params_npz(args.weights), meta.arch)
        model.load_state_dict({k: v.to(device) for k, v in state.items()})
    elif args.weights:
        from ..utils.checkpoint import load_torchvision_state_dict
        model.load_state_dict(load_torchvision_state_dict(args.weights, meta.arch, meta.fold_bn,
                                                          device))
    else:
        print(f'=> no weights given; random init for {args.arch} '
              '(accuracy numbers will be meaningless)')
    return dict(model.state_dict())


def data_loader(args, size: int):
    """(batches, real_data) of ``data/imagenet.make_loader`` with the JAX
    CLI's arguments: ``-sh``, ``-kld`` and ``-ac`` shuffle real data
    (``RandomState(seed)``); the synthetic fallback (8 batches, or ``subset //
    batch`` of them) is never shuffled, its images are i.i.d. already.  A
    class-folder tree on a machine without PIL exits, naming the ``.npz``
    route."""
    from ..data.imagenet import make_loader
    try:
        return make_loader(args.data, args.arch, args.batch_size,
                           shuffle=bool(args.kld_threshold or args.aciq_cal or args.shuffle),
                           limit=args.subset, seed=args.seed or 12345, size=size,
                           workers=args.workers)
    except ImportError as e:
        raise SystemExit(f'--data {args.data}: {e}') from e


def _unsharded(args, mesh):
    """[(flag, reason)] of the runs asked for that the sharded path does not
    cover."""
    out = []
    if args.stats_mode == 'collect' and args.kld_threshold:
        out.append(('-sm collect -kld', 'the KLD capture runs on one process'))
    for flag, on in (('-ms', args.measure_stats), ('-dd', args.dump_dir),
                     ('-me', args.measure_entropy)):
        if on:
            out.append((flag, 'it runs on one process'))
    if mesh.data > 1:
        for flag, on in (('-mtq', args.mid_thread_quant), ('-ra', args.rho_act is not None)):
            if on:
                out.append((flag, "its batch reductions are not the global batch's"))
    return out


def mesh_from_args(args, device):
    """The evaluation mesh of ``--mesh_data``/``--mesh_model``: None without
    a process group (the single-device path), which admits only the 1x1
    mesh; under torchrun the (data, model) grid of its ranks."""
    from ..parallel import make_mesh
    from ..parallel.distributed import init_distributed
    if args.serving_packed and args.mesh_model > 1:
        raise SystemExit('--serving_packed cannot run with --mesh_model > 1: the int4 codes '
                         'pack in groups of 256 along K, which a channel slice would cut')
    if not init_distributed(device=device):
        if (args.mesh_data or 1) * args.mesh_model != 1:
            raise SystemExit(f'--mesh_data {args.mesh_data} --mesh_model {args.mesh_model}: a '
                             'mesh larger than 1x1 needs a process group; launch under '
                             'torchrun (one rank a device)')
        return None
    try:
        mesh = make_mesh(data=args.mesh_data, model=args.mesh_model)
    except ValueError as e:
        raise SystemExit(f'--mesh_data/--mesh_model: {e}') from e
    for flag, why in _unsharded(args, mesh):
        raise SystemExit(f'{flag} under a process group: {why}')
    return mesh


def _s2d_stem_applied(params_s) -> bool:
    """True if ``prepare_serving_params`` space-to-depth transformed the stem
    kernel (``int_conv.is_s2d_stem_weight``)."""
    from ..ops.kernels.int_conv import is_s2d_stem_weight
    return any(is_s2d_stem_weight(v) for v in params_s.values())


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_flags(args)
    packed = packed_from_args(args)

    from ..calib.calibrator import (collect_statistics, default_stats_path,
                                    load_stats, save_stats)
    from ..engine import QuantEngine, QuantPolicy
    from ..engine.evaluate import evaluate
    from ..engine.policy import parse_qtype_bits
    from ..models import build_model
    from ..parallel import evaluate_sharded, shard_batch
    from ..parallel.distributed import local_device
    from ..utils.device import resolve_device
    from ..utils.eval_log import EvalLog

    device = resolve_device(args.device)
    mesh = mesh_from_args(args, device)
    if mesh is not None:
        device = local_device(device)
        if device.type == 'cuda' and device.index is not None:
            import torch
            torch.cuda.set_device(device)
    print(f"=> building model '{args.arch}' on {device}")
    model, meta = build_model(args.arch, dtype=args.dtype, device=device, seed=args.seed or 0,
                              input_size=args.input_size)
    params = load_params(args, model, meta)
    policy = policy_from_args(args)
    if args.q_off:
        policy = QuantPolicy(qtype=None, arch=args.arch)
    size = args.input_size or meta.input_size

    sf = args.stats_folder or args.arch
    if args.kld_threshold:
        sf += '_kld_' + (args.qtype or '')
    stats_path = default_stats_path(sf, per_channel=args.per_channel_quant_act)
    loader, real_data = data_loader(args, size)
    if not real_data:
        print('=> ImageNet not found; using synthetic data')
    engine = QuantEngine(model, policy, meta)

    # ---------------- collect mode -------------------------------------
    if args.stats_mode == 'collect':
        print('Collecting statistics...')
        err_bits = parse_qtype_bits(args.qtype) if args.qtype else None
        cal = args.cal_set_size if (args.kld_threshold or args.aciq_cal) else None
        batches = loader
        if mesh is not None:
            # each rank collects its slice of every batch; the statistics are
            # the global batch's, and the image count stops at the same batch
            batches = (shard_batch(mesh, x, y) for x, y in loader)
            cal = None if cal is None else -(-cal // mesh.data)
        summary = collect_statistics(
            engine.make_collect(batch_avg=args.stats_batch_avg, err_bits=err_bits, mesh=mesh),
            params, batches, cal_set_size=cal)
        if args.kld_threshold:
            from ..calib.kld import add_kld_thresholds
            add_kld_thresholds(summary, engine, params, loader,
                               cal_set_size=args.cal_set_size)
        if _rank() == 0:   # every rank holds the same statistics
            save_stats(stats_path, summary)
        _barrier()
        print(f'Saved statistics for {len(summary)} sites -> {stats_path}')
        return 0

    stats = None
    if args.stats_mode == 'use':
        if not os.path.exists(stats_path):
            raise SystemExit(f'no stats at {stats_path}; run -sm collect')
        stats = load_stats(stats_path)
        print(f'Loaded statistics for {len(stats)} sites from {stats_path}')

    params_q = engine.quantize_params(params)

    def run_eval(eng, p, quantized=True):
        # with stats, every site whose quantizer needs no live tensor runs
        # frozen (engine/qparams.py), one fake-quant kernel launch a site
        qparams = None
        if quantized and stats is not None and eng.policy.qtype is not None:
            qparams = eng.freeze_qparams(stats, input_shape=(1, size, size, 3))
            print(f'Froze qparams for {len(qparams)} sites')
        if mesh is not None:
            return evaluate_sharded(eng, p, loader, mesh=mesh, stats=stats,
                                    quantized=quantized, subset=args.subset, qparams=qparams)
        return evaluate(eng, p, loader, stats=stats, quantized=quantized,
                        subset=args.subset, print_freq=args.print_freq, verbose=True,
                        qparams=qparams)

    # ---------------- precision sweep ----------------------------------
    if args.eval_precision:
        elog = EvalLog(['dtype', 'val_prec1', 'val_prec5'])
        print('\nFloat32 no quantization')
        res = run_eval(engine, params, quantized=False)
        elog.log('fp32', res['top1'], res['top5'])
        for q in (8, 7, 6, 5, 4):
            qargs = argparse.Namespace(**vars(args))
            qargs.qtype = f'int{q}'
            eng = QuantEngine(model, policy_from_args(qargs), meta)
            print(f'\nQuantize to int{q}')
            res = run_eval(eng, params_q)
            elog.log(f'int{q}', res['top1'], res['top5'])
        print(elog)
        elog.save(f'results/precision/{args.arch}_{args.clipping}_clipping.csv')
        return 0

    # ---------------- layer-sensitivity sweep --------------------------
    if args.custom_test:
        order = _load_order(args, stats)
        log_name = (f'results/custom_test/{args.arch}_max_mse_{args.clipping}'
                    '_cliping_layer_selection.csv')
        elog = EvalLog(['num_8bit_layers', 'indexes', 'val_prec1', 'val_prec5'],
                       log_name, auto_save=True)
        for i in range(len(order) + 1):
            eight_bit = ['conv0_activation'] + order[:i]
            print(f'it: {i}, 8 bit layers: {len(eight_bit)}')
            eng = QuantEngine(model, policy, meta, ignore_ids=tuple(eight_bit))
            res = run_eval(eng, params_q)
            elog.log(i + 1, str(eight_bit), res['top1'], res['top5'])
        print(elog)
        return 0

    # ---------------- float-vs-quantized measurement ---------------------
    if args.measure_stats:
        from ..calib.measure import measure_statistics, save_measure_csv
        frames = measure_statistics(engine, params, params_q, loader, stats=stats)
        out = save_measure_csv(
            frames, os.path.join(os.path.expanduser('~'), 'mxt-sim-tpu', 'distance',
                                 args.arch), args.arch)
        print(f'Saved measurement summary for {len(frames)} sites -> {out}')
        return 0

    # ---------------- tensor dump (debug) -------------------------------
    if args.dump_dir:
        from ..utils.dump_manager import dump_activations
        images, _ = next(iter(loader))
        names = dump_activations(engine, params_q, images, args.dump_dir)
        print(f'Dumped {len(names)} activations to {args.dump_dir}')
        return 0

    # ---------------- plain validation ---------------------------------
    from ..utils.tracker import MetricsTracker
    experiment = args.mlf_experiment or args.arch
    name = f'{args.arch}_W{args.qweight}A{args.qtype}'
    if args.serving_int8:
        name += '_serving'
    if mesh is not None:   # one run directory a rank
        name += f'_rank{_rank()}'
    with MetricsTracker('~/mlruns_mxt_tpu', experiment, args, name) as tracker:
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
            if mesh is not None:
                res = evaluate_sharded(engine, params_s, loader, mesh=mesh, stats=stats,
                                       quantized='serving_int8', act_scales=scales,
                                       packed=packed, subset=args.subset)
            else:
                res = evaluate(engine, params_s, loader, stats=stats, quantized='serving_int8',
                               act_scales=scales, packed=packed, subset=args.subset,
                               print_freq=args.print_freq, verbose=True)
        else:
            res = run_eval(engine, params_q if policy.qtype else params,
                           quantized=policy.qtype is not None)
        for k in ('top1', 'top5', 'loss'):
            tracker.log_metric(k, res[k])
        print(f" * Prec@1 {res['top1']:.3f} Prec@5 {res['top5']:.3f} "
              f"({res['images_per_sec']:.1f} img/s on {device})")
        if args.measure_entropy and 'avg_entropy' in res:
            tracker.log_metric('avg.entropy.act', res['avg_entropy'])
            print(f"Average bit rate: avg.entropy.act - {res['avg_entropy']}")
        print(json.dumps({k: round(float(v), 4) for k, v in res.items()}))
    return 0


def _rank() -> int:
    from ..parallel.mesh import world
    return world()[0]


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _load_order(args, stats):
    """Layer ordering for the sensitivity sweep: an explicit file, or derived
    from calibration-time quantization-error stats, largest mse first (the
    reference hardcodes measured per-arch orderings, inference_sim.py:
    114-125)."""
    if args.order_file:
        with open(args.order_file) as f:
            return json.load(f)
    if stats:
        errs = {site: float(np.asarray(e['scalar/mean_mse_lowp']))
                for site, e in stats.items() if 'scalar/mean_mse_lowp' in e}
        if errs:
            return [s for s, _ in sorted(errs.items(), key=lambda kv: -kv[1])]
    raise SystemExit('custom_test needs --order_file or stats with mse columns '
                     '(-sm use after a collect run with error stats)')


if __name__ == '__main__':
    sys.exit(main())
